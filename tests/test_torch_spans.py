"""The port's spans and counters (``vae_cyclegan_tpu_torch/utils/spans.py``)
on the CPU at a tiny size (image 32, base 8, latent 8, batch 2): off while
no profiler records; under ``torch.profiler`` one unit per
``Engine.train_step`` with its backward, gate and optimizer spans per
optimizer, and one per ``run_inference`` with its three spans; self times
and nesting; the ``vct::`` counts and the ranges against the Chrome trace
the profiler exports."""

import json
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.data import DataLoader
from vae_cyclegan_tpu_torch.engine import Engine
from vae_cyclegan_tpu_torch.inference import run_inference
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.utils import spans

IMAGE, BASE, LATENT, BATCH, STEPS = 32, 8, 8, 2, 2
#: the optimizers' keys of a step, in the order the step runs them
KEYS = {"cyclevaegan": ["G", "D"], "autoencoder": ["optimizer"]}
PHASE_KEYS = {"host_ms_per_batch", "h2d_wait_ms_per_batch",
              "dispatch_ms_per_batch", "final_sync_ms", "window_ms_per_batch"}


class _Frames:
    """STEPS batches of seeded float frames."""

    def __len__(self):
        return BATCH * STEPS

    def get(self, idx, rng):
        r = np.random.RandomState(idx)
        return {k: r.rand(IMAGE, IMAGE, 3).astype(np.float32)
                for k in ("x", "y")}


def _task(arch):
    task = create_task(arch, model=ModelConfig(IMAGE, LATENT, BASE),
                       paired=False, device="cpu")
    task.init(0)
    return task


def _epoch(engine):
    return engine.train_epoch(DataLoader(_Frames(), BATCH, num_workers=1,
                                         use_processes=False),
                              progress=False)


def _images(seed):
    return np.random.RandomState(seed).rand(BATCH, IMAGE, IMAGE, 3).astype(
        np.float32)


def _profiled(fn, path):
    """(what `fn` returned, the units recorded, the exported trace's
    events) of `fn` under a CPU profiler that records shapes."""
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        out = fn()
    p.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    units = spans.units()
    spans.reset()
    return out, units, events


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture(scope="module", params=sorted(KEYS))
def trained(request, tmp_path_factory):
    """(architecture, units, trace events) of one profiled epoch."""
    torch.manual_seed(0)
    engine = Engine(_task(request.param))
    _, units, events = _profiled(
        lambda: _epoch(engine), tmp_path_factory.mktemp("t") / "trace.json")
    return request.param, units, events


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    task = _task("cyclevaegan")
    want = [run_inference(task, {"x": _images(i)}, seed=i) for i in range(2)]
    got, units, events = _profiled(
        lambda: [run_inference(task, {"x": _images(i)}, seed=i)
                 for i in range(2)],
        tmp_path_factory.mktemp("s") / "trace.json")
    return want, got, units, events


def test_off_without_a_profiler(monkeypatch):
    """With no profiler recording, an epoch and a request keep no record and
    open no range; the epoch's phases are still taken."""
    def refuse(*a):
        raise AssertionError("a range was opened with no profiler")

    monkeypatch.setattr(spans, "_range", refuse)
    assert not spans.on()
    engine = Engine(_task("autoencoder"))
    _epoch(engine)
    run_inference(engine.task, {"x": _images(0)})
    assert spans.units() == []
    assert set(engine.epoch_phases) == PHASE_KEYS


def test_a_profiled_step_records_one_unit(trained):
    """One ``vct.step`` unit per step, in order: ``vct.prep``, then per
    optimizer ``vct.backward``, ``vct.gate`` and ``vct.optimizer`` under its
    key, all directly inside the step; the copy wait before it and the
    loader wait after it; the K1 calls counted."""
    arch, units, _ = trained
    assert [u["name"] for u in units] == ["vct.step"] * STEPS
    assert [u["index"] for u in units] == list(range(STEPS))
    want = [("vct.prep", None)] + [
        (name, key) for key in KEYS[arch]
        for name in ("vct.backward", "vct.gate", "vct.optimizer")]
    for u in units:
        assert [(s["name"], s["key"]) for s in u["spans"]] == want
        assert all(s["parent"] is None for s in u["spans"])
        assert [w["name"] for w in u["waits"]] == ["vct.h2d_wait",
                                                  "vct.loader_wait"]
        assert u["ops"]["vct::in_act"]["calls"] > 0
        assert u["cpu_ns"] > 0 and u["process_ns"] > 0


def test_self_times_and_nesting(trained):
    """Self times are >= 0, every span lies inside its unit, the copy wait
    before it and the loader wait after it."""
    _, units, _ = trained
    for u in units:
        start, end = u["start_ns"], u["start_ns"] + u["wall_ns"]
        inner = sum(s["wall_ns"] for s in u["spans"] if s["parent"] is None)
        assert u["wall_ns"] - inner >= 0
        for s in u["spans"]:
            assert start <= s["start_ns"]
            assert s["start_ns"] + s["wall_ns"] <= end
            assert s["wall_ns"] >= 0 and s["cpu_ns"] >= 0
        h2d, loader = u["waits"]
        assert h2d["start_ns"] + h2d["wall_ns"] <= start
        assert loader["start_ns"] >= end


def test_op_counts_equal_the_trace(trained):
    """The per-op counts equal the ``vct::`` operators in the trace."""
    _, units, events = trained
    counted = Counter()
    for u in units:
        counted.update({k: v["calls"] for k, v in u["ops"].items()})
    traced = Counter(e["name"] for e in events if e.get("cat") == "cpu_op"
                     and e["name"].startswith("vct::"))
    assert counted == traced and counted


def _ranges(events):
    """{unit index: {(name, key): [(start, end), ...] in start order}} of
    the trace's ``vct.*`` ranges that carry a unit."""
    out = defaultdict(lambda: defaultdict(list))
    for e in sorted(events, key=lambda e: e.get("ts", 0)):
        args = e.get("args", {})
        if e.get("name", "").startswith("vct.") and "unit" in args:
            out[args["unit"]][(e["name"], args.get("key"))].append(
                (e["ts"], e["ts"] + e["dur"]))
    return out


def test_trace_ranges_nest_as_recorded(trained):
    """In the trace each unit's ranges carry its index, match its recorded
    spans one for one, and lie inside the unit's range."""
    _, units, events = trained
    ranges = _ranges(events)
    assert sorted(ranges) == [u["index"] for u in units]
    for u in units:
        got = ranges[u["index"]]
        (root,) = got.pop((u["name"], None))
        want = Counter((s["name"], s["key"]) for s in u["spans"])
        assert {k: len(v) for k, v in got.items()} == dict(want)
        for start, end in (r for v in got.values() for r in v):
            assert root[0] <= start <= end <= root[1]


def test_run_inference_records_a_request(served):
    """A request is a ``vct.request`` unit of ``vct.to_device``,
    ``vct.generate`` and ``vct.to_host``, its ``vct::`` calls as in the
    trace; the answers are those of the unprofiled requests."""
    want, got, units, events = served
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert [u["name"] for u in units] == ["vct.request"] * 2
    for u in units:
        assert [(s["name"], s["parent"]) for s in u["spans"]] == [
            ("vct.to_device", None), ("vct.generate", None),
            ("vct.to_host", None)]
        assert u["waits"] == []
    counted = Counter()
    for u in units:
        counted.update({k: v["calls"] for k, v in u["ops"].items()})
    assert counted == Counter(e["name"] for e in events
                              if e.get("cat") == "cpu_op"
                              and e["name"].startswith("vct::"))


def test_units_are_bounded_and_waits_attached(monkeypatch):
    """The buffer keeps the newest ``MAX_UNITS``; a wait belongs to the next
    unit ("next"), to the unit just closed ("last") or to none; a span
    outside a unit opens its range and keeps nothing."""
    monkeypatch.setattr(spans, "MAX_UNITS", 3)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("vct.prep"):
            pass
        for _ in range(5):
            with spans.wait("vct.h2d_wait", "next"):
                pass
            with spans.unit("vct.request"):
                with spans.span("vct.generate"):
                    pass
            with spans.wait("vct.loader_wait", "last"):
                pass
            with spans.wait("vct.loader_wait"):
                pass
    units = spans.units()
    assert [u["index"] for u in units] == [2, 3, 4]
    for u in units:
        assert [w["name"] for w in u["waits"]] == ["vct.h2d_wait",
                                                  "vct.loader_wait"]
        assert [s["name"] for s in u["spans"]] == ["vct.generate"]


def test_counts_go_to_the_next_unit():
    """``count`` from another thread adds to the record of the next unit
    to open, and counts nothing while no profiler records."""
    import threading

    spans.reset()
    spans.count("loader_batches.processes")
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.unit("vct.step"):
            pass
        workers = [threading.Thread(target=spans.count, args=(name,))
                   for name in ["loader_batches.processes"] * 3
                   + ["loader_batches.threads"]]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in workers)
        for _ in range(2):
            with spans.unit("vct.step"):
                pass
    assert [u["counts"] for u in spans.units()] == [
        {}, {"loader_batches.processes": 3, "loader_batches.threads": 1}, {}]


def test_instance_norm_counts_each_sites_path():
    """While spans are on, every in-process IN+act site counts its path,
    ``instance_norm.kernel`` (K1 or K2) or ``instance_norm.plain``, into
    the next unit; nothing while no profiler records."""
    from vae_cyclegan_tpu_torch.ops.instance_norm import instance_norm_act

    small = torch.ones(1, 64, 16, 16)      # a 64 KB slab: K1 by JAX's rule
    big = torch.ones(1, 80, 64, 64)        # over 1 MB: plain on the CPU

    def sites():
        instance_norm_act(small, act="relu", order="act_norm")
        instance_norm_act(big, act="relu", order="act_norm")
        instance_norm_act(big, act="relu", order="act_norm", mode="tiled")
        instance_norm_act(big, act="relu", order="act_norm", mode="plain")

    sites()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.unit("vct.step"):
            sites()
        with spans.unit("vct.step"):
            pass
    assert [u["counts"] for u in spans.units()] == [
        {}, {"instance_norm.kernel": 2, "instance_norm.plain": 2}]


def test_train_profile_dir_trace_has_the_ranges(tmp_path):
    """``train.py --profile_dir``'s trace of the first epoch holds the step's
    ranges and, recorded on every thread, the copy thread's and the
    loader's."""
    from PIL import Image

    from vae_cyclegan_tpu_torch import train as port_train

    rng = np.random.RandomState(0)
    d = tmp_path / "data" / "hypersim" / "ai_001_001_indoor" / "cam_00"
    d.mkdir(parents=True)
    for frame in range(4):
        for mod in ("depth", "normal"):
            Image.fromarray((rng.rand(40, 56, 3) * 255).astype(np.uint8)).save(
                d / f"frame_{frame:04d}_{mod}.png")
    argv = ["--platform", "cpu", "--architecture", "vae", "--paired",
            "--dataset", "hypersim", "--data_dir", str(tmp_path / "data"),
            "--source_modality", "depth", "--target_modality", "depth",
            "--image_size", "32", "--base_width", "8", "--latent_dim", "8",
            "--batch_size", "2", "--epochs", "1", "--test_split", "0.5",
            "--output_dir", str(tmp_path / "runs"), "--quiet",
            "--num_workers", "2", "--profile_dir", str(tmp_path / "prof")]
    port_train.main(port_train.build_parser().parse_args(argv))
    (path,) = (tmp_path / "prof").glob("*.json")
    with open(path) as f:
        names = Counter(e.get("name") for e in json.load(f)["traceEvents"])
    assert names["vct.step"] == 1
    for name in ("vct.prep", "vct.backward", "vct.gate", "vct.optimizer",
                 "vct.h2d_wait", "vct.loader_wait", "vct.h2d_copy",
                 "vct.load_batch"):
        assert names[name] >= 1, name
