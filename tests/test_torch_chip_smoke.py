"""chip_smoke.py off the card: without CUDA it exits non-zero and prints no
result; its training phase (phase 4) runs end to end on the CPU at a cut
size, so its control flow is checked before it reaches a GPU (the CPU
runs the plain attention, which launches nothing)."""

import os
import subprocess
import sys

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
    ("void (anonymous namespace)::attention_train_rows_long<float, 16>(float const*)",
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
    (the backward's long-row route), each causal or with a key mask of T -
    10, f32 and bf16, at rates 0, 0.1 and 0.5."""
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
    launch nothing, so every expected count is 0; a missed threshold fails
    the phase after its numbers are printed."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from regennet_torch.ops import attention

    study = cs.load_capability_study()
    results = _guard_results()
    results.update(cmdm_training=dict(layers=2, steps=800, diffusion_steps=50),
                   walls_s=dict(data=0.1), total_s=1.0)
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


def test_path_launches_add_up(monkeypatch):
    """The kernel line's launches: each kernel summed over its paths, B2
    by direction, phases 8 and 10 included."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    paths = {"fused_attention_btd": {"phase 3": 24000, "phase 5": 8000, "phase 6": 64000,
                                     "phase 8": 400, "phase 10": 53200},
             "fused_attention_btd_train": {
                 "phase 4": {"forward": 320, "backward": 320},
                 "phase 5": {"forward": 128, "backward": 128},
                 "phase 8": {"forward": 1600, "backward": 1600},
                 "phase 10": {"forward": 256, "backward": 256}},
             "fused_causal_attention": {"phase 2c": 26}}
    assert cs.path_launches(paths, "fused_attention_btd") == 149600
    assert cs.path_launches(paths, "fused_attention_btd_train", "forward") == 2304
    assert cs.path_launches(paths, "fused_attention_btd_train", "backward") == 2304
    assert cs.path_launches(paths, "fused_causal_attention") == 26
