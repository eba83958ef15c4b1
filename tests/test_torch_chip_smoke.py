"""chip_smoke.py off the card: without CUDA it exits non-zero and prints no
result; its training phase (phase 4) runs end to end on the CPU at a cut
size, so its control flow is checked before it reaches a GPU (the CPU
runs the plain attention, which launches nothing)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for each test: the suite runs in several
    processes at once, and torch's spinning thread pools then slow these
    runs of small ops by more than ten times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_exits_nonzero_without_cuda():
    assert not torch.cuda.is_available()
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_training_phase_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder

    for key, value in dict(layers=2, latent_dim=64, heads=2, T=24).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)
    for key, value in dict(batch=4, steps=8, steps_per_call=2).items():
        monkeypatch.setitem(cs.TRAIN, key, value)
    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,csv")  # restored after
    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=16,
                                             min_len=34, max_len=48),
                  dataname="chi3d", split="test", num_frames=24, num_person=2,
                  pose_rep="rot6d")
    report = {}
    save_dir = tmp_path / "train"
    loop, loader, launches = cs.run_training(report, "cpu", save_dir, device="cpu")
    assert launches == {"forward": 0, "backward": 0}
    assert loop.state_step == 8
    cs.check_train_step(report, loop, loader)
    cs.sample_trained(report, save_dir, data, device="cpu")
    row = report["training"]
    assert row["first_logged"]["step"] == 0 and row["last_logged"]["step"] == 6
    assert report["train_step_check"]["loss_kernel"] == pytest.approx(
        report["train_step_check"]["loss_plain"], rel=1e-6)
    assert report["trained_sample"]["checkpoint"] == "model000000008.pt"


def test_offline_and_eval_phases_run_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    """Phases 5 and 6 at a cut size: train_mdm with the default --arch, a
    step check, DDPM from its checkpoint, then eval_cmdm (debug, CFG 2.5,
    random ST-GCN) on phase 4's checkpoint, with its results file and the
    ST-GCN's CPU-vs-CPU comparison (the CPU runs launch nothing)."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder

    for key, value in dict(layers=2, latent_dim=32, heads=2, T=12, steps=4).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)
    for key, value in dict(batch=4, steps=4, steps_per_call=2).items():
        monkeypatch.setitem(cs.TRAIN, key, value)
    monkeypatch.setattr(cs, "OFFLINE_STEPS", 4)
    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,csv")  # restored after
    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=16,
                                             min_len=14, max_len=24),
                  dataname="chi3d", split="test", num_frames=12, num_person=2,
                  pose_rep="rot6d")
    report = {}
    assert cs.run_offline(report, "cpu", tmp_path / "offline", data, device="cpu") == (
        {"forward": 0, "backward": 0}, 0)
    assert report["offline_training"]["arch"] == "trans_enc"
    assert report["offline_sample"]["sampler"] == "DDPM 4"
    cs.run_training(report, "cpu", tmp_path / "train", device="cpu")
    assert cs.run_eval(report, "cpu", tmp_path / "train" / "model000000004.pt",
                       device="cpu") == 0
    row = report["evaluation"]
    assert row["sampling_calls"] == 8 and row["sampled_rows"] == 8 * 32
    assert row["stgcn_batches"] == 16 and row["results_file"].endswith("_debug_000000004.yaml")


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::attention_fwd_kernel<__nv_bfloat16, 160>((anonymous "
     "namespace)::FwdArgs)", "attention forward (B1, B3)"),
    ("void (anonymous namespace)::attention_fwd_kernel<float, 64>(FwdArgs)",
     "attention forward (B1, B3)"),
    ("void (anonymous namespace)::attention_fwd_kernel<float, 160, true, false, true>("
     "(anonymous namespace)::FwdArgs)", "training attention forward"),
    ("void (anonymous namespace)::attention_fwd_kernel<__nv_bfloat16, 64, false, true, true>("
     "(anonymous namespace)::FwdArgs)", "training attention forward"),
    ("void (anonymous namespace)::attention_fwd_kernel<float, 160, true, false, false>("
     "(anonymous namespace)::FwdArgs)", "attention forward (B1, B3)"),
    ("void (anonymous namespace)::attention_train_rows<float, 16, false>(float const*)",
     "training attention backward"),
    ("void (anonymous namespace)::attention_train_rows<float, 16>(float const*)",
     "training attention backward"),
    ("void (anonymous namespace)::attention_train_rows<float, 16, true>(float const*)",
     "training attention backward"),
    ("void (anonymous namespace)::attention_train_cols<__nv_bfloat16>(x)",
     "training attention backward"),
    ("void (anonymous namespace)::attention_train_cols<float, true>(float const*, float "
     "const*, float const*, float const*, float const*, float*, float*, int const*, int, "
     "unsigned int, float, float, (anonymous namespace)::RowArgs)",
     "training attention backward"),
    ("void (anonymous namespace)::attention_train_cols<__nv_bfloat16, false>(x)",
     "training attention backward"),
    ("void (anonymous namespace)::attention_train_cols<__nv_bfloat16, true>(x)",
     "training attention backward"),
    ("void (anonymous namespace)::attention_train_rows<float, 160, true>(float const*, "
     "float const*, float const*, float const*, float*, float*, int const*, int, unsigned "
     "int, float, (anonymous namespace)::RowArgs)", "training attention backward"),
    ("void (anonymous namespace)::attention_train_rows<__nv_bfloat16, 64, false>(x)",
     "training attention backward"),
    ("void (anonymous namespace)::attention_train_rows_stored<float, true>(float const*)",
     "training attention backward"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x16", "dense GEMMs (cuBLAS)"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", "dense GEMMs (cuBLAS)"),
    ("void at::native::vectorized_elementwise_kernel<4>(...)", "other elementwise"),
])
def test_profile_kernel_groups(monkeypatch, name, group):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    assert cs._kernel_group(name) == group


def test_train_cases_draw_t200_last(monkeypatch):
    """Phase 2b's 84 cases: T 150, 60, 151 at B 8 and 64, then T 200 at B 8
    (the backward's row pass with P in shared memory), each causal or with
    a key mask of T - 10, f32 and bf16, at rates 0, 0.1 and 0.5."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    cases = list(cs.train_cases())
    assert len(cases) == 84 and len(set(cases)) == 84
    assert [(B, T) for B, T, *_ in cases[::12]] == [
        (8, 150), (8, 60), (8, 151), (64, 150), (64, 60), (64, 151), (8, 200)]
    assert {(causal, kv_len) for _, T, causal, kv_len, *_ in cases if T == 200} == {
        (True, None), (False, 190)}
    assert cases[:6] == [(8, 150, True, None, dtype, rate)
                         for dtype in ("float32", "bfloat16") for rate in (0.0, 0.1, 0.5)]


# a hand-made gradient: autograd of the plain forward, and the plain
# backward 1/16 away from it in one element (values exact in bf16 and f32)
AUTOGRAD = torch.tensor([[0.5, -3.0], [1.0, 2.0]])
PLAIN_BACKWARD = torch.tensor([[0.5, -2.9375], [1.0, 2.0]])


def test_bf16_gradient_tolerance_adds_the_plain_backwards_distance(monkeypatch):
    """At bf16 the kernel's gradient is held to the plain backward's own
    distance from autograd plus 2^-7 x max(1, max|plain backward|)."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    allowance = 2.0 ** -7 * 2.9375
    tol, terms = cs.gradient_tolerance(AUTOGRAD, PLAIN_BACKWARD, "bfloat16")
    assert tol == 0.0625 + allowance and terms == (0.0625, allowance)
    kernel = PLAIN_BACKWARD + torch.tensor([[0.0, -allowance], [0.0, 0.0]])
    err, tol, terms = cs.hold_gradient("dk", kernel, AUTOGRAD, PLAIN_BACKWARD, "bfloat16")
    assert terms == pytest.approx((0.0625, allowance))
    assert tol == pytest.approx(0.0625 + allowance)
    assert err == pytest.approx(0.0625 - allowance)
    # one allowance past the plain backward on the far side of autograd
    kernel = AUTOGRAD + torch.tensor([[0.0, 0.0625 + allowance], [0.0, 0.0]])
    assert cs.hold_gradient("dk", kernel, AUTOGRAD, PLAIN_BACKWARD, "bfloat16")[0] <= tol


def test_f32_gradient_tolerance_is_unchanged(monkeypatch):
    """At f32 the tolerance stays 1e-5 x max(1, max|autograd|): the plain
    backward's distance is not added."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    err, tol, terms = cs.hold_gradient("dq", AUTOGRAD + 2.0 ** -16, AUTOGRAD, PLAIN_BACKWARD,
                                       "float32")
    assert terms is None and tol == pytest.approx(3e-5)
    assert err == 2.0 ** -16
    with pytest.raises(AssertionError, match="dq disagrees"):
        cs.hold_gradient("dq", AUTOGRAD + 2.0 ** -15, AUTOGRAD, PLAIN_BACKWARD, "float32")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gradient_past_its_tolerance_raises(monkeypatch, dtype):
    """A kernel farther from autograd than the bound fails the check, as
    does a non-finite gradient."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    _, tol, _ = cs.hold_gradient("dv", AUTOGRAD, AUTOGRAD, PLAIN_BACKWARD, dtype)
    past = AUTOGRAD + torch.tensor([[0.0, 0.0], [0.0, 2 * tol]])
    with pytest.raises(AssertionError, match="dv disagrees"):
        cs.hold_gradient("dv", past, AUTOGRAD, PLAIN_BACKWARD, dtype)
    with pytest.raises(AssertionError):
        cs.hold_gradient("dv", AUTOGRAD * float("nan"), AUTOGRAD, PLAIN_BACKWARD, dtype)


@pytest.mark.parametrize("arch", ["gru", "mlp"])
def test_trunk_phase_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path, arch):
    """Phase 7 at a cut size: train_mdm with --arch gru / mlp --cm_mode add
    (no attention launches on any device: these trunks attend nothing),
    the GRU's bias_hh check, and DDPM from the checkpoint."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder

    for key, value in dict(layers=2, latent_dim=32, heads=2, T=12, steps=4).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)
    for key, value in dict(batch=4, steps=4, steps_per_call=2).items():
        monkeypatch.setitem(cs.TRAIN, key, value)
    monkeypatch.setattr(cs, "TRUNK_STEPS", 4)
    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,csv")  # restored after
    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=16,
                                             min_len=14, max_len=24),
                  dataname="chi3d", split="test", num_frames=12, num_person=2,
                  pose_rep="rot6d")
    report = {}
    assert cs.run_trunk(report, "cpu", tmp_path / arch, data, arch, device="cpu") == {
        "forward": 0, "backward": 0}
    assert report[f"{arch}_training"]["arch"] == arch
    assert report[f"{arch}_sample"]["sampler"] == "DDPM 4"
    assert report[f"{arch}_sample"]["ms_per_step"] > 0


def test_bf16_phase_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    """Phase 9 at a cut size: bf16 train_mdm with the in-training
    evaluation after each save, its state f32, a bf16 step check (three
    routes, phase 2b's bf16 bound), a bf16 DDIM request; then the offline,
    gru and mlp trunks at bf16 with the bf16-vs-f32 forward check (the CPU
    runs launch nothing)."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder

    # a 50-step schedule: the evaluations sample DDPM 50, the request DDIM 50
    for key, value in dict(layers=2, latent_dim=32, heads=2, T=12, steps=50).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)
    for key, value in dict(batch=4, steps=8, steps_per_call=2).items():
        monkeypatch.setitem(cs.TRAIN, key, value)
    monkeypatch.setattr(cs, "TRUNK_STEPS", 4)
    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,csv")  # restored after
    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=16,
                                             min_len=14, max_len=24),
                  dataname="chi3d", split="test", num_frames=12, num_person=2,
                  pose_rep="rot6d")
    report = {}
    b2, b1 = cs.run_bf16_training(report, "cpu", tmp_path / "bf16", data, device="cpu")
    assert b2 == {"forward": 0, "backward": 0} and b1 == 0
    row = report["bf16_training"]
    assert row["compute_dtype"] == "bfloat16" and len(row["evaluations"]) == 2
    assert row["eval_sampling_calls"] == 4  # one batch of 32 a split, at each save
    check = report["bf16_train_step_check"]
    assert check["dtype"] == "bfloat16" and check["loss_kernel"] == check["loss_plain"]
    assert check["worst_gradient"]["max_abs_err"] == 0.0  # the CPU runs the plain path
    assert report["bf16_trained_sample"]["compute_dtype"] == "bfloat16"
    for arch in ("trans_enc", "gru", "mlp"):
        assert cs.run_bf16_trunk(report, "cpu", tmp_path / arch, data, arch,
                                 device="cpu") == {"forward": 0, "backward": 0}
        assert report[f"bf16_{arch}_training"]["compute_dtype"] == "bfloat16"
        assert report[f"{arch}_bfloat16_forward_check"]["max_abs_err"] > 0


def test_a2m_phase_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    """Phase 10 at a cut size: train_mdm on HumanAct12 from --data_path
    with the legacy in-training evaluation, eval_humanact12_uestc on its
    checkpoint, an --unconstrained CMDM through the unconstrained protocol,
    UESTC training and evaluation, compute_accuracy, the classifiers'
    CPU-vs-CPU comparison (the CPU runs launch nothing)."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    for key, value in dict(layers=2, latent_dim=32, heads=2, T=12, steps=10).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)  # T: compute_accuracy's Chi3D clips
    monkeypatch.setitem(cs.TRAIN, "steps_per_call", 2)
    for key, value in dict(batch=4, steps=4, eval_batch=4, eval_samples=2,
                           uestc_steps=2, uncon_steps=2, uncon_diffusion_steps=5, clips=24,
                           uestc_videos=24, modi_struct=20).items():
        monkeypatch.setitem(cs.A2M, key, value)
    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,csv")  # restored after
    report = {}
    launches = cs.run_a2m(report, "cpu", tmp_path, device="cpu")
    assert launches == {"b1": 0, "b2": {"forward": 0, "backward": 0}}
    training = report["a2m_training"]
    assert (training["arch"], training["steps"], training["batch"]) == ("trans_enc", 4, 4)
    assert len(training["evaluations"]) == 2 and training["eval_sampling"]["sampling_calls"] == 2
    # debug mode, 10 samples at batch 4: 3 batches a seed (the third crosses
    # 10); the unconstrained protocol then samples the 24 clips' 6 batches;
    # UESTC stacks both seeds' batches (train 3, test the split's 8 clips)
    for key, rows, steps in (("a2m_eval_humanact12", [4] * 6, 10),
                             ("a2m_eval_unconstrained", [4] * 12, 5),
                             ("a2m_eval_uestc", [8] * 5, 10)):
        row = report[key]
        assert row["sampling_rows"] == rows, key
        assert row["sampling_steps"] == len(rows) * steps, key
        assert row["classifier_calls"] > 0 and row["ms_per_denoiser_step"] > 0
    assert set(report["a2m_compute_accuracy"]["accuracies"]) == {"train", "test"}
    assert report["a2m_classifiers_card_vs_cpu_worst_scaled"] == {
        "GRU classifier": 0.0, "unconstrained ST-GCN": 0.0}


def test_t2m_phase_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    """Phase 11 at a cut size: the seeded CLIP tower file and merge table,
    the encoder against a CPU copy, train_mdm --dataset humanml from
    --data_path (196 frames: the window is the dataset's), a step check,
    sample.generate with CFG on the checkpoint and its results.npy; the
    CLIP route, not the hashed stand-in, encodes every caption and prompt
    (the CPU runs launch nothing)."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from regennet_torch.models import clip_text

    for key, value in dict(layers=2, latent_dim=32, heads=2, steps=5).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)
    monkeypatch.setitem(cs.TRAIN, "steps_per_call", 2)
    for key, value in dict(batch=4, steps=4, clips=16, samples=2).items():
        monkeypatch.setitem(cs.T2M, key, value)
    for key, value in dict(vocab_size=600, dim=64, heads=1, num_layers=2).items():
        monkeypatch.setitem(cs.CLIP_TOWER, key, value)
    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,csv")  # restored after
    monkeypatch.delenv("REGENNET_CLIP_PATH", raising=False)
    encoded = []
    encoder_call = clip_text.ClipTextEncoder.__call__
    monkeypatch.setattr(clip_text.ClipTextEncoder, "__call__",
                        lambda self, texts: encoded.append(len(texts)) or encoder_call(self,
                                                                                        texts))
    report = {}
    launches = cs.run_t2m(report, "cpu", tmp_path, device="cpu")
    assert launches == {"b1": 0, "b2": {"forward": 0, "backward": 0}}
    assert "REGENNET_CLIP_PATH" not in os.environ  # restored after the phase
    training = report["t2m_training"]
    assert (training["arch"], training["steps"], training["batch"]) == ("trans_enc", 4, 4)
    assert report["t2m_clip_tower"]["shape"] == [3, 512]
    assert report["t2m_train_step_check"]["loss_kernel"] == pytest.approx(
        report["t2m_train_step_check"]["loss_plain"], rel=1e-6)
    generated = report["t2m"]["generate"]
    assert generated["sampling_rows"] == [2] and generated["sampling_steps"] == 5
    assert report["t2m"]["motion_shape"] == [2, 120, 22, 3]
    # the tower check (twice), 4 training batches, the step check's batch,
    # the generate request
    assert encoded == [3, 3, 4, 4, 4, 4, 4, 2]


def test_t2m_bf16_phase_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    """Phase 11b at a cut size on phase 11's assets: train_mdm --dataset
    humanml --compute_dtype bfloat16, every self-attention call at bf16
    [B, 197, D] (layers x steps), a bf16 step check, no hashed text
    embeddings (the CPU runs launch nothing)."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    for key, value in dict(layers=2, latent_dim=32, heads=2, steps=5).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)
    monkeypatch.setitem(cs.TRAIN, "steps_per_call", 2)
    for key, value in dict(batch=4, steps=4, clips=16, samples=2).items():
        monkeypatch.setitem(cs.T2M, key, value)
    for key, value in dict(vocab_size=600, dim=64, heads=1, num_layers=2).items():
        monkeypatch.setitem(cs.CLIP_TOWER, key, value)
    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,csv")  # restored after
    monkeypatch.delenv("REGENNET_CLIP_PATH", raising=False)
    cs.write_t2m_assets(tmp_path)
    report = {}
    assert cs.run_t2m_bf16(report, "cpu", tmp_path, device="cpu") == {"forward": 0,
                                                                      "backward": 0}
    assert "REGENNET_CLIP_PATH" not in os.environ  # restored after the phase
    training = report["t2m_bf16_training"]
    assert (training["arch"], training["compute_dtype"], training["steps"],
            training["batch"]) == ("trans_enc", "bfloat16", 4, 4)
    assert report["t2m_bf16"]["attended"] == {"4x197x32xbfloat16": 8}
    check = report["t2m_bf16_train_step_check"]
    assert check["dtype"] == "bfloat16" and check["worst_gradient"]["ratio"] <= 1.0


def test_text_evaluation_phase_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    """Phase 12 at a cut size, after phase 11 on the same workdir: the GloVe
    archive, train_t2m_eval --stage all (the evaluators at their published
    widths), the trained networks against CPU copies, eval_humanml debug
    with CFG, train_mdm with the in-training evaluation, generate
    --length_estimator; every word vectorizer reads the archive and every
    text goes through the CLIP route (the CPU runs launch nothing). The
    evaluators' widths are cut too."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from regennet_torch.models import t2m_eval

    for key, value in dict(layers=2, latent_dim=32, heads=2, steps=5).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)
    monkeypatch.setitem(cs.TRAIN, "steps_per_call", 2)
    for key, value in dict(batch=4, steps=4, clips=16, samples=2).items():
        monkeypatch.setitem(cs.T2M, key, value)
    for key, value in dict(vocab_size=600, dim=64, heads=1, num_layers=2).items():
        monkeypatch.setitem(cs.CLIP_TOWER, key, value)
    for key, value in dict(epochs=1, batch=8, train_steps=2, eval_samples=4,
                           lengths=3).items():
        monkeypatch.setitem(cs.T2M_EVAL, key, value)
    for key, value in dict(dim_text_hidden=32, dim_coemb_hidden=16, dim_motion_hidden=48,
                           dim_movement_enc_hidden=32, dim_movement_latent=24).items():
        monkeypatch.setitem(t2m_eval.T2M_OPT, key, value)
    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,csv")  # restored after
    monkeypatch.delenv("REGENNET_CLIP_PATH", raising=False)
    cwd = os.getcwd()
    cs.run_t2m({}, "cpu", tmp_path, device="cpu")
    report = {}
    launches = cs.run_t2m_eval(report, "cpu", tmp_path, device="cpu")
    assert launches == {"b1": 0, "b2": {"forward": 0, "backward": 0}}
    assert os.getcwd() == cwd and "REGENNET_CLIP_PATH" not in os.environ  # restored
    assert (tmp_path / "glove" / "our_vab_data.npy").is_file()
    assert set(report["t2m_evaluators_card_vs_cpu_share"]) == {
        "movement encoder", "movement decoder", "text tower", "motion tower",
        "length estimator"}
    rows = report["t2m_eval"]
    # debug: 2 replications of one batch, the test split's 8 clips (32 asked)
    assert rows["eval"]["sampling_rows"] == [8, 8] and rows["eval"]["sampling_steps"] == 10
    assert rows["in_training"]["sampling_rows"] == [4]
    assert rows["generate"]["sampling_rows"] == [3] and len(rows["generate"]["lengths"]) == 3
    assert rows["glove_vectorizers"] >= 4 and 0 < rows["sampling_share"] < 1
    assert report["t2m_eval_training"]["steps"] == 2


def test_comp_v6_phase_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    """Phase 13 at a cut size, after phases 11 and 12 on the same workdir:
    train_t2m_gen from phase 12's decomp, the trained generator against a
    CPU copy, eval_humanml debug on the .pt and on the same state as a
    latest.tar (the same log), generate's comp_v6 route through both (the
    same motions), motion_process on seeded raw joints with the recovery
    check on both devices (here both the CPU). The evaluators' widths are
    cut too, the movement encoder's hidden width to its latent's, as the
    published ones are."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from regennet_torch.models import t2m_eval

    for key, value in dict(layers=2, latent_dim=32, heads=2, steps=5).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)
    monkeypatch.setitem(cs.TRAIN, "steps_per_call", 2)
    for key, value in dict(batch=4, steps=4, clips=16, samples=2).items():
        monkeypatch.setitem(cs.T2M, key, value)
    for key, value in dict(vocab_size=600, dim=64, heads=1, num_layers=2).items():
        monkeypatch.setitem(cs.CLIP_TOWER, key, value)
    for key, value in dict(epochs=1, batch=8, train_steps=2, eval_samples=4,
                           lengths=3).items():
        monkeypatch.setitem(cs.T2M_EVAL, key, value)
    for key, value in dict(dim_text_hidden=32, dim_coemb_hidden=16, dim_motion_hidden=48,
                           dim_movement_enc_hidden=24, dim_movement_latent=24).items():
        monkeypatch.setitem(t2m_eval.T2M_OPT, key, value)
    for key, value in dict(dim_z=4, pri_hidden=16, dec_hidden=16, text_hidden=8, att_vec=8,
                           n_layers=2, epochs=2, batch=4, prompts=2, raw_clips=3).items():
        monkeypatch.setitem(cs.COMP_V6, key, value)
    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,csv")  # restored after
    monkeypatch.delenv("REGENNET_CLIP_PATH", raising=False)
    cwd = os.getcwd()
    cs.run_t2m({}, "cpu", tmp_path, device="cpu")
    cs.run_t2m_eval({}, "cpu", tmp_path, device="cpu")
    report = {}
    cs.run_comp_v6(report, "cpu", tmp_path, device="cpu")
    assert os.getcwd() == cwd
    rows = report["comp_v6"]
    # 16 clips at batch 4: 4 steps an epoch
    assert rows["training"]["steps"] == 8 and rows["training"]["ms_per_step"] > 0
    assert set(report["comp_v6_card_vs_cpu_share"]) == {
        f"{k} tf={tf}" for k in ("fake_motions", "fake_movements", "mus_pri", "logvars_pri",
                                 "mus_post", "logvars_post") for tf in (0, 1)}
    # debug: two replications of the test split's 8 clips, one prior sampling each
    assert [c[:2] for c in rows["eval"]["generate_calls"]] == [(8, 49), (8, 49)]
    assert [c[:2] for c in rows["generate"]["generate_calls"]] == [(2, 49)]
    assert rows["preprocessing"]["frames"] > 0 and 0 < rows["wall_s"]
    assert (tmp_path / "released" / "comp_v6" / "eval_humanml_comp_v6_debug.log").is_file()


def test_median_block_ms_drops_the_warmup(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    assert cs.median_block_ms([100.0, 50.0] + [1.0] * 8 + [3.0] * 8 + [2.0] * 8) == 2.0
    assert cs.median_block_ms([9.0, 9.0, 4.0, 6.0]) == 5.0  # fewer than a block: one


def _guard_results(**acc_fid):
    """A learning-guard artefact that passes every threshold, with
    (accuracy, FID) of a row replaced by acc_fid[row]."""
    gt = acc_fid.pop("gt", 1.0)
    rows = dict(trained=(0.4, 1.0), random_init=(0.125, 10.0), oracle=(0.9, 0.01))
    rows.update(acc_fid)
    out = {row: {"accuracy_gen_test": {"mean": a}, "fid_gen_test": {"mean": f}}
           for row, (a, f) in rows.items()}
    out["evaluator"] = {"gt_test_accuracy": gt}
    return out


@pytest.mark.parametrize("miss,name,what", [
    (dict(gt=0.59), "evaluator_pass", "evaluator GT accuracy 0.5900"),
    (dict(trained=(0.2, 1.0)), "trained_acc_above_chance", "chance + 0.10"),
    (dict(random_init=(0.41, 10.0)), "trained_acc_above_random", "random-init 0.4100"),
    (dict(random_init=(0.125, 3.9)), "trained_fid_much_below_random",
     "0.25 x random-init FID 3.9"),
    (dict(oracle=(0.49, 0.01)), "oracle_preserves_signal", "oracle accuracy 0.4900"),
    (dict(oracle=(0.9, 0.1)), "oracle_fid_far_below_trained", "0.1 x trained FID"),
    (dict(trained=(0.6, 1.0), oracle=(0.5, 0.01)), "oracle_is_ceiling", "+ 0.05"),
])
def test_a_learning_guard_threshold_that_misses_raises(monkeypatch, miss, name, what):
    """Each check of the learning guard (the six thresholds of
    tests/test_capability_smoke.py; the second splits in two) fails phase 8
    alone when it misses, naming its numbers; an artefact that meets them
    all passes."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    study = cs.load_capability_study()
    study.require_learning(_guard_results())
    checks = study.guard_checks(_guard_results(**dict(miss)))
    assert [n for n, (held, _) in checks.items() if not held] == [name]
    with pytest.raises(AssertionError, match="missed") as err:
        study.require_learning(_guard_results(**miss))
    assert what in str(err.value) and str(err.value).count(";") == 0


def test_learning_guard_phase_reads_launches_around_the_study(monkeypatch, tmp_path):
    """Phase 8's control flow with the study stubbed: the launch counts
    are zeroed before the study and read after it; on the CPU the kernels
    launch nothing, so every expected count is 0; the curve and the chosen
    (step, guidance) are printed; a missed threshold fails the phase after
    its numbers are printed."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from regennet_torch.ops import attention

    study = cs.load_capability_study()
    results = _guard_results()
    results.update(cmdm_training=dict(layers=2, steps=800, diffusion_steps=50),
                   walls_s=dict(data=0.1), total_s=1.0,
                   fid_vs_step=[dict(step=s, accuracy_gen_train=0.3, accuracy_gen_test=0.3,
                                     fid_gen_test=2.0) for s in (2, 402, 704)],
                   selection=dict(candidates=[704, 402], guidance_sweep=[1.0],
                                  chosen_step=704, chosen_guidance=1.0))
    results["checked"] = [what for _, what in study.guard_checks(results).values()]
    attention.fused_attention_btd.launches = 5  # from an earlier phase

    class Stub:
        require_learning = staticmethod(study.require_learning)

        @staticmethod
        def run_study(device, workdir):
            assert attention.fused_attention_btd.launches == 0
            return dict(results)

    monkeypatch.setattr(cs, "load_capability_study", lambda: Stub)
    report = {}
    launches = cs.run_learning_guard(report, "cpu", tmp_path, device="cpu")
    assert launches == {"fused_attention_btd": 0,
                        "fused_attention_btd_train": {"forward": 0, "backward": 0}}
    assert report["learning_guard"]["sampling_calls"] == 0
    results["trained"]["accuracy_gen_test"]["mean"] = 0.1
    with pytest.raises(AssertionError, match="missed"):
        cs.run_learning_guard({}, "cpu", tmp_path, device="cpu")


def test_learning_guard_phase_runs_the_cut_study_on_cpu(monkeypatch, tmp_path, capsys):
    """Phase 8 around the real study cut to the smoke scale (with the
    reduced ST-GCN trained one epoch, 8 samples): the sampling loops it
    counts are the study's own, one curve point per checkpoint and the
    chosen (step, guidance) are printed, the launch counts hold (0 on the
    CPU), and the guard's thresholds, which a smoke run does not learn to
    meet, fail the phase after its numbers."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    study = cs.load_capability_study()  # a module of its own: the cut stays in it
    study.SCALES["smoke"] = dict(study.SCALES["smoke"], stgcn=study.REDUCED_STGCN,
                                 stgcn_epochs=1)
    ran = {}

    class Cut:
        require_learning = staticmethod(study.require_learning)

        @staticmethod
        def run_study(device, workdir):
            ran["results"] = study.run_study(device, workdir, "smoke",
                                             headline_samples=8)
            return ran["results"]

    monkeypatch.setattr(cs, "load_capability_study", lambda: Cut)
    report = {}
    with pytest.raises(AssertionError, match="missed"):
        cs.run_learning_guard(report, "cpu", tmp_path / "guard", device="cpu")
    results = ran["results"]
    guard = report["learning_guard"]
    assert guard["sampling_calls"] == results["launches"]["sampling_calls"] > 0
    steps = sorted(int(n[5:14]) for n in os.listdir(tmp_path / "guard" / "cmdm_save")
                   if n.startswith("model"))
    assert [p["step"] for p in results["fid_vs_step"]] == steps
    out = capsys.readouterr().out
    assert out.count("  curve, step ") == len(steps)
    sel = results["selection"]
    assert f"chosen (step, guidance) ({sel['chosen_step']}, {sel['chosen_guidance']})" in out


def test_path_launches_add_up(monkeypatch):
    """The kernel line's launches: each kernel summed over its paths, B2
    by direction, phases 8, 10, 11 and 12 included."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    paths = {"fused_attention_btd": {"phase 3": 24000, "phase 5": 8000, "phase 6": 64000,
                                     "phase 8": 400, "phase 10": 53200, "phase 11": 8000,
                                     "phase 12": 32000},
             "fused_attention_btd_train": {
                 "phase 4": {"forward": 320, "backward": 320},
                 "phase 5": {"forward": 128, "backward": 128},
                 "phase 8": {"forward": 1600, "backward": 1600},
                 "phase 10": {"forward": 256, "backward": 256},
                 "phase 11": {"forward": 128, "backward": 128},
                 "phase 12": {"forward": 64, "backward": 64}},
             "fused_causal_attention": {"phase 2c": 26}}
    assert cs.path_launches(paths, "fused_attention_btd") == 189600
    assert cs.path_launches(paths, "fused_attention_btd_train", "forward") == 2496
    assert cs.path_launches(paths, "fused_attention_btd_train", "backward") == 2496
    assert cs.path_launches(paths, "fused_causal_attention") == 26


def test_cvae_launch_arithmetic(monkeypatch):
    """Phase 14's CVAE path by token count: B2 once each way in each of the
    4 encoder layers (62 tokens) and 4 decoder layers (60 tokens) a step, B1
    never in training; at inference B1 once a layer of each encoder and
    decoder call, so 4 x the decoder calls of generate_sequences at 60."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    assert cs.cvae_launches(4, 16, 0, 0, 60) == {
        "b1_by_T": {}, "b2_by_T": {"forward": {62: 64, 60: 64},
                                   "backward": {62: 64, 60: 64}}}
    assert cs.cvae_launches(4, 0, 0, 2, 60)["b1_by_T"] == {60: 8}  # 2 rows x 4 layers
    assert cs.cvae_launches(4, 0, 1, 1, 60) == {
        "b1_by_T": {62: 4, 60: 4}, "b2_by_T": {"forward": {}, "backward": {}}}
    assert cs.cvae_launches(0, 16, 1, 1, 60) == {  # the CPU launches nothing
        "b1_by_T": {}, "b2_by_T": {"forward": {}, "backward": {}}}
    assert (cs.CVAE["T"], cs.CVAE["batch"], cs.CVAE["latent_dim"], cs.CVAE["layers"]) == \
        (60, 20, 256, 4)  # the JAX train_cvae CLI's defaults: head dim 64 at 4 heads
    assert (cs.CVAE["vertices"], cs.CVAE["faces"]) == (10475, 20908)  # SMPL-X's mesh


def test_phase14_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    """Phase 14 at a cut size after phases 4 and 11 (also cut): the edits on
    the online CMDM (both modes) and the text CMDM (the seeded CLIP tower),
    each keeping the inpainted entries; the Predictor against cgenerate;
    train_cvae, its step check, its forward against a CPU copy,
    generate_sequences to vertices and the rasterizer on the CPU twice. The
    CPU runs launch nothing."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder

    for key, value in dict(layers=2, latent_dim=32, heads=2, T=24, steps=5).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)
    for key, value in dict(batch=4, steps=4, steps_per_call=2).items():
        monkeypatch.setitem(cs.TRAIN, key, value)
    for key, value in dict(batch=4, steps=2, clips=16, samples=2).items():
        monkeypatch.setitem(cs.T2M, key, value)
    for key, value in dict(vocab_size=600, dim=64, heads=1, num_layers=2).items():
        monkeypatch.setitem(cs.CLIP_TOWER, key, value)
    for key, value in dict(T=8, batch=4, latent_dim=16, layers=1, clips=8, frames_drawn=3,
                           frames_held=2, size=32, vertices=255, faces=300).items():
        monkeypatch.setitem(cs.CVAE, key, value)
    monkeypatch.setitem(cs.EDIT, "batch", 3)
    monkeypatch.setitem(cs.EDIT, "predict_batch", 2)
    monkeypatch.setitem(cs.EDIT, "predict_steps", 5)
    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,csv")  # restored after
    monkeypatch.delenv("REGENNET_CLIP_PATH", raising=False)
    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=8, min_len=34,
                                             max_len=48),
                  dataname="chi3d", split="test", num_frames=24, num_person=2,
                  pose_rep="rot6d")
    report = {}
    cs.run_training(report, "cpu", tmp_path / "train", device="cpu")
    cs.run_t2m(report, "cpu", tmp_path / "t2m", device="cpu")
    launches = cs.run_phase14(report, "cpu", tmp_path, data, device="cpu")
    assert launches["b1"] == 0 and launches["b2"] == {"forward": 0, "backward": 0}
    edits = report["edits"]
    assert [(e["model"], e["mode"]) for e in edits] == [
        ("online", "in_between"), ("online", "upper_body"), ("text", "upper_body")]
    assert [e["sampling_steps"] for e in edits] == [5, 5, 5]
    assert all(0 < e["kept_share"] < 1 for e in edits)
    assert report["predict"]["max_abs_err"] <= 1e-5
    assert report["cvae"]["steps"] == 2
    assert report["cvae_train_step_check"]["loss_kernel"]["mixed"] == pytest.approx(
        report["cvae_train_step_check"]["loss_plain"]["mixed"], rel=1e-6)
    raster = report["cvae_raster"]
    assert (raster["frames"], raster["frames_held"], raster["worst_share"]) == (3, 2, 0)
    assert (raster["vertices"], raster["faces"]) == (255, 600)  # two persons' faces
    from regennet_torch.ops import body_model
    assert body_model.get_body_model("smplx").num_vertices == 567  # the fallback again


def test_gan_launch_arithmetic(monkeypatch):
    """Phase 15's GAN path by token count, 2 layers, 8 iterations: hinge, B2
    at D's 60 frames 3 times a layer each way (D on the real and the fake
    batch, D in the G step), at G's 16 tokens once; B1 at 16 once (the D
    step's fake). wgan-gp adds D on the interpolates: a forward, and two
    backward passes (the penalty's gradient, then back through D's forward
    under the loss's gradient) with one second-order call a layer."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    assert cs.gan_launches(2, 8, "hinge", 60, 16) == {
        "b1_by_T": {16: 16}, "b2_by_T": {"forward": {60: 48, 16: 16},
                                         "backward": {60: 48, 16: 16}}, "b2_double": 0}
    assert cs.gan_launches(2, 8, "wgan-gp", 60, 16) == {
        "b1_by_T": {16: 16}, "b2_by_T": {"forward": {60: 64, 16: 16},
                                         "backward": {60: 80, 16: 16}}, "b2_double": 16}
    assert cs.gan_launches(0, 8, "wgan-gp", 60, 16) == {  # the CPU launches nothing
        "b1_by_T": {}, "b2_by_T": {"forward": {}, "backward": {}}, "b2_double": 0}
    assert (cs.GAN["batch"], cs.GAN["T"], cs.GAN["latent_dim"], cs.GAN["nnoise"],
            cs.GAN["Z"]) == (32, 60, 256, 16, 32)  # the JAX train_gan CLI's defaults
    assert "  15. " in cs.__doc__ and "phases 3,\n5, 6, 8, 9, 10, 11, 12, 14 and 15" in cs.__doc__


class _CardLikeB2(torch.autograd.Function):
    """B2 as the card runs it under autograd, on the CPU: the plain forward
    and, for the backward, `_AttentionTrainBackward` (so a second
    derivative takes the second-order term), each counted by T in the
    wrapper's counters as the kernels count their launches."""

    @staticmethod
    def forward(ctx, q, k, v, seed, cfg):
        from regennet_torch.ops import attention

        b2 = attention.fused_attention_btd_train
        b2.launches += 1
        b2.launches_by_tokens[q.shape[1]] = b2.launches_by_tokens.get(q.shape[1], 0) + 1
        ctx.save_for_backward(q, k, v, seed)
        ctx.cfg = cfg
        with torch.no_grad():
            return attention.attention_btd_train_reference(q, k, v, cfg.num_heads, cfg.rate,
                                                           seed, cfg.causal)

    @staticmethod
    def backward(ctx, dout):
        from regennet_torch.ops import attention

        q, k, v, seed = ctx.saved_tensors
        b2 = attention.fused_attention_btd_train
        b2.backward_launches += 1
        by_T = b2.backward_launches_by_tokens
        by_T[q.shape[1]] = by_T.get(q.shape[1], 0) + 1
        return (*attention._AttentionTrainBackward.apply(q, k, v, dout.contiguous(), seed,
                                                         ctx.cfg), None, None)


@pytest.mark.parametrize("loss_mode", ["hinge", "wgan-gp"])
def test_gan_launches_match_a_card_like_run(monkeypatch, tmp_path, loss_mode):
    """gan_launches against train_gan run on the CPU with B1 and B2 counting
    as the card's wrappers count (B2 differentiated through its
    second-order Function), at a cut size."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from regennet_torch.models import transformer
    from regennet_torch.ops import attention
    from regennet_torch.train import train_gan

    for key, value in dict(batch=4, T=8, latent_dim=16, nnoise=4, Z=3, iters=2).items():
        monkeypatch.setitem(cs.GAN, key, value)
    b1 = attention.fused_attention_btd

    def counted_b1(q, k, v, num_heads, causal=True, softmax_f32=False, kv_len=None):
        b1.launches += 1
        b1.launches_by_tokens[q.shape[1]] = b1.launches_by_tokens.get(q.shape[1], 0) + 1
        return attention.attention_btd_reference(q, k, v, num_heads, causal, softmax_f32,
                                                 kv_len)

    def card_like_b2(q, k, v, num_heads, rate, seed, causal=True, softmax_f32=False,
                     kv_len=None):
        return _CardLikeB2.apply(q, k, v, seed, attention._TrainConfig(
            num_heads, float(rate), causal, softmax_f32, 0))

    monkeypatch.setattr(transformer, "fused_attention_btd", counted_b1)
    monkeypatch.setattr(transformer, "fused_attention_btd_train", card_like_b2)
    data = cs.gan_feeder(cs.GAN["iters"] * cs.GAN["batch"])
    _, counts = cs.counted_run(lambda: train_gan.main(
        cs.gan_args(tmp_path / "gan", loss_mode), device="cpu", data=data), "cpu")
    want = cs.gan_launches(2, 2, loss_mode, 8, 4)
    assert {k: counts[k] for k in want} == want


def test_phase15_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    """Phase 15 at a cut size after phase 14's CVAE (also cut): train_gan in
    both modes with the d_step checks, the generation, evaluate_cvae on the
    CVAE's checkpoint and the fit against its CPU copy. The CPU runs launch
    nothing."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    for key, value in dict(T=8, batch=4, latent_dim=16, layers=1, clips=8, frames_drawn=2,
                           frames_held=1, size=16, vertices=255, faces=300).items():
        monkeypatch.setitem(cs.CVAE, key, value)
    for key, value in dict(batch=4, T=8, latent_dim=16, nnoise=4, Z=3, iters=2, classes=2,
                           per_class=2, fit_T=4, fit_steps=6, fit_held=3).items():
        monkeypatch.setitem(cs.GAN, key, value)
    report = {}
    cs.run_cvae(report, "cpu", tmp_path, device="cpu")
    launches = cs.run_phase15(report, "cpu", tmp_path, device="cpu")
    assert launches == {"b1": 0, "b2": {"forward": 0, "backward": 0}, "b1_by_T": {},
                        "b2_by_T": {"forward": {}, "backward": {}}, "b2_double": 0}
    for mode in ("hinge", "wgan-gp"):
        assert report[f"gan_{mode}"]["iters"] == 2
        check = report[f"gan_{mode}_d_step_check"]
        assert check["loss_kernel"]["lossD"] == pytest.approx(check["loss_plain"]["lossD"],
                                                              rel=1e-6)
    assert set(report["gan_eval"]["metrics"]) == {"feats", "other"}
    fit = report["gan_fit"]
    assert fit["steps"] == 6 and fit["last_loss"] < fit["first_loss"]
    assert report["phase15"]["fit_ms_per_step"] > 0


def test_phase16_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    """Phase 16 at a cut size on the CPU: train_mdm at --data_parallel 2 and
    --tensor_parallel 2 on two gloo ranks (spawned, as on the card) held
    against one process, the tensor-parallel DDPM sample against one
    process on the same weights, the sampler
    extras with PLMS against a CPU copy, and torch_ckpt --check over the
    phase's own checkpoints. (b), the NCCL group at world 1 with FSDP, is
    skipped: the CPU has no NCCL (tests/test_torch_distributed.py holds
    FSDP over gloo). The CPU runs launch nothing."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    for key, value in dict(layers=2, latent_dim=32, heads=4, T=16).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)
    monkeypatch.setitem(cs.DIST, "batch", 8)
    monkeypatch.setitem(cs.DIST, "sample_rows", 4)
    for key, value in dict(respacing="10", batch=4).items():
        monkeypatch.setitem(cs.EXTRAS, key, value)
    monkeypatch.setattr(cs, "CKPT_KINDS", ("cmdm/online",))
    monkeypatch.setenv("REGENNET_LOG_FORMAT", "human,json")
    report = {}
    launches = cs.run_phase16(report, "cpu", tmp_path, device="cpu")
    assert launches == {"b1": 0, "b2": {"forward": 0, "backward": 0}}
    dist = report["phase16_distributed"]
    assert dist["nccl"].startswith("skipped")
    for name, steps in (("dp", cs.DIST["steps"]), ("tp", 1)):
        assert len(dist[name]["losses"]) == steps == dist[name]["steps"]
        np.testing.assert_allclose(dist[name]["losses"], dist["one_process_losses"][:steps],
                                   rtol=1e-5)
    assert dist["tp"]["ranks"][0]["heads"] == [2]
    assert dist["tp"]["sample_err"] < 1e-5  # the same weights, one forward apart
    extras = report["phase16_extras"]
    # the same plain attention on both sides, batches of 4 rows and of 1
    assert extras["plms_cpu_err"] < 1e-5 and np.isfinite(extras["round_trip_err"])
    assert set(report["phase16_ckpt_check"]["checked"]) == {"cmdm/online"}
    # one process and dp, each saved after its first and its last step; tp's one step
    assert len(report["phase16_ckpt_check"]["checked"]["cmdm/online"]) == 5


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_phase16_launch_arithmetic(monkeypatch, order):
    """extras_model_calls against the loops' own denoiser calls: PLMS at
    order k makes steps + 1 calls for k > 1 (steps for k = 1), the reverse
    DDIM loop and DDIM steps each, the bpd loop steps; B1 launches layers
    times each on the card."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    import torch

    from regennet_torch.diffusion import DiffusionConfig, losses, make_schedule, sampling

    sched, cfg, shape = make_schedule("cosine", 1000, timestep_respacing="7"), \
        DiffusionConfig(), (2, 3, 2, 4)
    calls = []

    def model_fn(x, t, cond):
        calls.append(1)
        return torch.tanh(x)

    counts = {}
    for name, run in (
            ("plms", lambda: sampling.plms_sample_loop(sched, cfg, model_fn, shape, {},
                                                       order=order,
                                                       generator=torch.Generator())),
            ("round_trip", lambda: sampling.ddim_sample_loop(
                sched, cfg, model_fn, shape, {}, generator=torch.Generator(),
                noise=sampling.ddim_reverse_sample_loop(sched, cfg, model_fn,
                                                        torch.zeros(shape), {}))),
            ("bpd", lambda: losses.calc_bpd_loop(sched, cfg, model_fn, torch.zeros(shape), {},
                                                 generator=torch.Generator()))):
        calls.clear()
        run()
        counts[name] = len(calls)
    assert counts == cs.extras_model_calls(7, order)
    assert cs.extras_model_calls(50, 2) == {"plms": 51, "round_trip": 100, "bpd": 50}
    assert 8 * cs.extras_model_calls(50, 2)["plms"] == 408


def test_stgcn_tf32_check_runs_on_cpu_at_a_cut_size(monkeypatch, tmp_path):
    """Phase 6's ST-GCN check at a cut size on the CPU: train_stgcn.main
    started with TF32 allowed leaves both flags False, the comparison is
    recorded, and the contract is pinned again after it (the CPU has no
    TF32: the logits agree)."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    for key, value in dict(clips=16, T=24, batch=8, epochs=1).items():
        monkeypatch.setitem(cs.STGCN_TF32, key, value)
    report = {}
    res = cs.check_stgcn_tf32(report, "cpu", tmp_path, device="cpu")
    assert report["stgcn_tf32"] is res
    assert res["flags_before"] == (True, True) and res["flags_after"] == (False, False)
    assert cs.tf32_flags() == (False, False)
    assert res["logits_max_abs_diff"] == 0.0 and res["argmax_agreement"] == 1.0
    assert res["gt_accuracy_f32"] == res["gt_accuracy_tf32"]
    assert (tmp_path / "stgcn_tf32" / "model000000001.pt").exists()


def _cut_fresh_models(monkeypatch, cs):
    for key, value in dict(latent_dim=64, layers=2).items():
        monkeypatch.setitem(cs.FLAGSHIP, key, value)
        monkeypatch.setitem(cs.CVAE, key, value)
    for key in ("dim_z", "pri_hidden", "dec_hidden", "text_hidden", "att_vec"):
        monkeypatch.setitem(cs.COMP_V6, key, 32)


def test_fresh_parameters_phase_runs_on_cpu_at_a_cut_size(monkeypatch):
    """Phase 1b on the CPU (the CMDMs, the CVAE and comp_v6 cut in width):
    every family's fresh parameters meet their Flax initialisers."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    _cut_fresh_models(monkeypatch, cs)
    report = {}
    cs.check_fresh_parameters(report, "cpu", device="cpu")
    rows = report["fresh_parameters"]
    assert set(rows) == {name for name, *_ in cs.fresh_models()}
    for row in rows.values():
        assert row["std_over_tol"] <= 1.0
        assert row["max_over_truncation"] <= 1.0 + 1e-6
        assert row["orthogonality"] <= 1e-5
    assert rows["cmdm gru"]["orthogonality"] > 0  # its recurrent gates were held


def test_fresh_parameters_phase_fails_on_torch_defaults(monkeypatch):
    """Phase 1b raises on a model left at torch's default initialisation."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    _cut_fresh_models(monkeypatch, cs)
    what, build, _, own = cs.fresh_models()[0]

    def seeded_build():  # torch's defaults, the same on both builds
        torch.manual_seed(0)
        return build()

    monkeypatch.setattr(cs, "fresh_models", lambda: [(what, seeded_build, lambda m, g: m, own)])
    with pytest.raises(AssertionError, match="std"):
        cs.check_fresh_parameters({}, "cpu", device="cpu")


@pytest.mark.parametrize("arg,expected", [
    ("", None),
    ("2,2b", {"2", "2b"}),
    ("13", {"11", "12", "13"}),
    ("11b", {"11", "11b"}),
    ("15", {"3", "4", "11", "14", "15"}),
    ("6,16", {"3", "4", "6", "16"}),
])
def test_phase_selection_adds_what_a_phase_needs(monkeypatch, arg, expected):
    """--phases runs the phases named and those whose results or files they
    take; without it every phase runs. Phase 16 then requires the
    checkpoint kinds of the phases that ran."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    selected = cs.select_phases(["--phases", arg] if arg else [])
    assert selected == (set(cs.PHASES) if expected is None else expected)
    kinds = cs.ckpt_kinds(selected)
    if expected is None:
        assert kinds == cs.CKPT_KINDS
    elif arg == "6,16":
        assert kinds == ("cmdm/online", "stgcn")


def test_phase_selection_rejects_an_unknown_phase(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    with pytest.raises(SystemExit):
        cs.select_phases(["--phases", "2,17"])
