"""regennet_torch.utils.profiling's spans and counters: nothing recorded and
no record_function opened while recording is off; nesting, threads and
request ids while it is on; the spans on the clock of torch.profiler's
Chrome trace; and the spans and blocking copies that one text training
block and one sampling loop record on the CPU."""

import gzip
import json
import os
import threading

import numpy as np
import pytest
import torch

from regennet_torch.utils import profiling

STEPS = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _by_name(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


def _inside(span, ancestor) -> bool:
    while span is not None:
        if span is ancestor:
            return True
        span = span.parent
    return False


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    first = profiling.span("a")
    assert profiling.span("b", request=3) is first  # one shared no-op context
    assert profiling.blocking() is first and profiling.new_request() is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("a"), profiling.blocking():
            profiling.count("host_syncs")
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_spans_nest_across_threads_with_request_ids():
    with profiling.recording() as rec:
        request = profiling.new_request()
        with profiling.span("outer", request) as outer:
            with profiling.span("inner") as inner:
                pass

            def other():
                with profiling.span("elsewhere"):
                    with profiling.span("deeper"):
                        pass

            worker = threading.Thread(target=other)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
        with profiling.span("after", profiling.new_request()):
            pass
    spans = _by_name(rec)
    assert [s.name for s in rec.spans] == ["inner", "deeper", "elsewhere", "outer", "after"]
    assert inner.parent is outer and outer.parent is None
    assert outer.request == inner.request == request
    assert spans["after"][0].request not in (None, request)
    here = threading.get_native_id()
    assert outer.tid == inner.tid == here
    elsewhere, deeper = spans["elsewhere"][0], spans["deeper"][0]
    assert elsewhere.tid == deeper.tid != here
    # the other thread's spans keep a stack of their own
    assert elsewhere.parent is None and deeper.parent is elsewhere
    assert elsewhere.request is None
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert outer.start_ns <= elsewhere.start_ns <= elsewhere.end_ns <= outer.end_ns


def test_counters_count_only_while_recording():
    profiling.count("host_syncs")
    with profiling.recording() as rec:
        profiling.count("host_syncs")
        profiling.count("copies", 3)
        with profiling.blocking():
            pass
    profiling.count("host_syncs")
    with profiling.blocking():
        pass
    assert rec.counters == {"host_syncs": 2, "copies": 3}
    assert [s.name for s in rec.spans] == ["sync"]
    with pytest.raises(RuntimeError, match="already on"):
        with profiling.recording():
            with profiling.recording():
                pass


def test_counters_and_spans_from_many_threads_add_up():
    """More threads than cores, a short switch interval: no lost update."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def work():
                for _ in range(500):
                    with profiling.span("w"):
                        profiling.count("n")

            threads = [threading.Thread(target=work) for _ in range(2 * (os.cpu_count() or 4))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert rec.counters["n"] == 500 * len(threads) == len(rec.spans)
    assert all(s.parent is None for s in rec.spans)


def test_spans_lie_on_the_chrome_trace_clock(tmp_path):
    """A span's time.time_ns() interval brackets its own record_function
    event at ts x 1000 + baseTimeNanoseconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            for name in ("first", "second"):
                with profiling.span(name):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith(profiling.PREFIX)}
    for s in rec.spans:
        e = events[profiling.PREFIX + s.name]
        start = round(float(e["ts"]) * 1000) + base
        end = start + round(float(e["dur"]) * 1000)
        assert s.start_ns <= start <= end <= s.end_ns, (s, e)


# -- the program's spans: one text training block, one sampling loop ----

VOCAB, WIDTH = 600, 32
MERGES = [("h", "e"), ("l", "l"), ("w", "a"), ("l", "k"), ("wa", "lk"), ("p", "e")]


@pytest.fixture
def tiny_clip(tmp_path, monkeypatch):
    """A 1-layer CLIP text tower (width 32, CLIP's 512 projection) and a
    tiny merge table, found through the environment as the trainer finds
    the released ones."""
    from regennet_torch.models.clip_text_tower import ClipTextTower

    bpe = str(tmp_path / "bpe_simple_vocab_16e6.txt.gz")
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES))
    torch.manual_seed(0)
    tower = ClipTextTower(VOCAB, 77, WIDTH, 1, 1, 512)
    for p in tower.parameters():
        torch.nn.init.normal_(p, std=0.02)
    path = str(tmp_path / "ViT-B-32.pt")
    torch.save(tower.state_dict(), path)
    monkeypatch.setenv("REGENNET_CLIP_PATH", path)
    monkeypatch.setenv("REGENNET_CLIP_BPE", bpe)


def _text_loop(tmp_path):
    from regennet_torch.train.train_platforms import NoPlatform
    from regennet_torch.train.training_loop import TrainLoop
    from regennet_torch.utils import kvlogger as logger
    from regennet_torch.utils import parser_util
    from regennet_torch.utils.model_util import (TextData, _pick_activation,
                                                 create_model_and_diffusion)

    args = parser_util.train_args([
        "--dataset", "humanml", "--setting", "mdm", "--arch", "trans_enc", "--cm_mode",
        "concat", "--layers", "1", "--latent_dim", "32", "--cond_mask_prob", "0.1",
        "--diffusion_steps", "10", "--batch_size", "2", "--steps_per_call", str(STEPS),
        "--save_dir", str(tmp_path / "run"), "--seed", "3"])
    args.activation = _pick_activation(args)
    logger.configure(None, formats=(), quiet=True)
    model, sched, dcfg = create_model_and_diffusion(args, TextData())
    T, rng = 8, np.random.default_rng(0)
    batches = []
    for _ in range(STEPS):
        y = {"mask": np.ones((2, 1, 1, T), bool), "lengths": np.full(2, T),
             "text": ["a person walks", "he walks fast"]}
        batches.append((rng.normal(size=(2, 263, 1, T)).astype(np.float32), {"y": y}))
    loop = TrainLoop(args, NoPlatform(str(tmp_path / "run")), model, sched, dcfg, batches,
                     torch.device("cpu"))
    return loop, batches


def test_a_training_block_records_each_step_and_its_blocking_copies(tmp_path, tiny_clip):
    loop, batches = _text_loop(tmp_path)
    with profiling.recording() as rec:
        loop.run_block(batches)
    spans = _by_name(rec)
    assert len(spans["train.block"]) == 1
    block = spans["train.block"][0]
    assert len(spans["train.host_batch"]) == len(spans["clip.encode"]) == STEPS
    assert len(spans["train.to_device"]) == STEPS
    steps = spans["train.step"]
    assert len(steps) == STEPS
    for step in steps:
        assert step.parent is block
        inner = {name: [s for s in spans[name] if _inside(s, step)]
                 for name in ("train.loss", "denoiser", "train.backward", "train.optimizer",
                              "attention.forward")}
        assert {k: len(v) for k, v in inner.items()} == {
            "train.loss": 1, "denoiser": 1, "train.backward": 1, "train.optimizer": 1,
            "attention.forward": 1}
        assert inner["denoiser"][0].parent is inner["train.loss"][0]
        for name in ("train.loss", "train.backward", "train.optimizer"):
            assert inner[name][0].parent is step
        loss, backward, opt = (inner[n][0] for n in ("train.loss", "train.backward",
                                                      "train.optimizer"))
        assert loss.end_ns <= backward.start_ns and backward.end_ns <= opt.start_ns
    for encode in spans["clip.encode"]:
        assert encode.parent.name == "train.host_batch"
    # a step: the tokens' copy and the embedding's read-back in clip.encode,
    # six pageable copies in train.to_device (motion, t, weights, mask,
    # cmotion, text_emb)
    syncs = spans["sync"]
    assert rec.counters == {"host_syncs": 8 * STEPS} and len(syncs) == 8 * STEPS
    assert sum(s.parent.name == "clip.encode" for s in syncs) == 2 * STEPS
    assert sum(s.parent.name == "train.to_device" for s in syncs) == 6 * STEPS
    # recording off: the same block records nothing more
    loop.run_block(batches)
    assert len(rec.spans) == sum(len(v) for v in spans.values())


def test_a_sampling_loop_records_one_step_span_per_step_under_one_request():
    from regennet_torch.diffusion import sampling
    from regennet_torch.diffusion.schedule import DiffusionConfig, make_schedule

    calls = []

    def model_fn(x, t, cond):
        with profiling.span("denoiser"):
            calls.append(int(t[0]))
            return x * 0.5

    sched = make_schedule(noise_schedule="cosine", steps=6, device="cpu")
    cfg = DiffusionConfig(model_mean_type="start_x", model_var_type="fixed_small")
    shape = (2, 3, 1, 4)
    with profiling.recording() as rec:
        for _ in range(2):
            sampling.p_sample_loop(sched, cfg, model_fn, shape, {}, clip_denoised=False,
                                   generator=torch.Generator().manual_seed(0))
    steps = _by_name(rec)["sample.step"]
    assert len(steps) == 2 * sched.num_timesteps == len(calls)
    first, second = steps[:sched.num_timesteps], steps[sched.num_timesteps:]
    assert len({s.request for s in first}) == len({s.request for s in second}) == 1
    assert first[0].request is not None and first[0].request != second[0].request
    for d in _by_name(rec)["denoiser"]:
        assert d.parent.name == "sample.step" and d.request == d.parent.request
