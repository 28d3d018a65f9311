"""What a port run writes around its steps, against the JAX package: the
memory-mapped file list and its lifecycle, the event tracker, the logger
backends, the profile trace and the system log. All on the CPU."""

import json
import logging
import pickle
import sys
import types

import numpy as np
import pytest

import lightly_train_tpu_torch as lt
from lightly_train_tpu._data.mmap_lifecycle import (
    dataset_mmap_path as jax_dataset_mmap_path,
)
from lightly_train_tpu._events import tracker as jax_tracker
from lightly_train_tpu._loggers import multi as JM
from lightly_train_tpu_torch._commands import train as T
from lightly_train_tpu_torch._data.memory_mapped_sequence import (
    SUFFIX,
    MemoryMappedSequence,
    write_items_to_file,
)
from lightly_train_tpu_torch._data.mmap_lifecycle import dataset_mmap_path
from lightly_train_tpu_torch._events import tracker
from lightly_train_tpu_torch._loggers import multi as M
from lightly_train_tpu_torch._system import get_system_information
from torch_fixtures.threads import one_torch_thread  # noqa: F401

SMALL = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
             local_view_count=2, global_image_size=28, local_image_size=14)


def write_images(folder, n=6, size=36):
    folder.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        (folder / f"{i}.ppm").write_bytes(
            f"P6\n{size} {size}\n255\n".encode() + img.tobytes())


# ---- the file list ------------------------------------------------------


def test_file_list_round_trips(tmp_path):
    """UTF-8 names, slices, negative indices and pickling by path; the
    port's own suffix, so a JAX ``.arrow`` file is never read as one."""
    items = ["/data/a.png", "/data/ü/b.jpg", "", "/d/é" * 50]
    path = tmp_path / f"list{SUFFIX}"
    write_items_to_file(items, path)
    seq = MemoryMappedSequence(path)
    assert SUFFIX != ".arrow"
    assert len(seq) == 4 and list(seq) == items
    assert seq[-1] == items[-1] and seq[1:3] == items[1:3]
    with pytest.raises(IndexError):
        seq[4]
    again = pickle.loads(pickle.dumps(seq))
    assert len(pickle.dumps(seq)) < 200 and list(again) == items
    (tmp_path / "other").write_bytes(b"ARROW1\0\0" + bytes(32))
    with pytest.raises(ValueError, match="not a file list"):
        len(MemoryMappedSequence(tmp_path / "other"))


# The five cases of tests/data/test_mmap_lifecycle.py, each in both
# packages.
@pytest.mark.parametrize("fn", [jax_dataset_mmap_path, dataset_mmap_path],
                         ids=["jax", "port"])
def test_cleanup_on_exit(tmp_path, fn):
    with fn("/data", tmp_path / "out", False, False) as p:
        p.write_bytes(b"x")
        assert p.exists()
        ref = p.with_suffix(".ref_count")
        assert ref.read_text() == "1"
    assert not p.exists()
    assert not ref.exists()


@pytest.mark.parametrize("fn", [jax_dataset_mmap_path, dataset_mmap_path],
                         ids=["jax", "port"])
def test_nested_refcount_keeps_file(tmp_path, fn):
    with fn("/data", tmp_path / "out", True, False) as p1:
        p1.write_bytes(b"x")
        with fn("/data", tmp_path / "out", True, False) as p2:
            assert p1 == p2
            assert p1.with_suffix(".ref_count").read_text() == "2"
        assert p1.exists()
    assert not p1.exists()


@pytest.mark.parametrize("fn", [jax_dataset_mmap_path, dataset_mmap_path],
                         ids=["jax", "port"])
def test_concurrent_run_detection(tmp_path, fn):
    ctx = fn("/data", tmp_path / "out", False, False)
    p = ctx.__enter__()
    try:
        p.write_bytes(b"x")
        with pytest.raises(RuntimeError, match="multiple runs"):
            with fn("/data", tmp_path / "out", False, False):
                pass
    finally:
        ctx.__exit__(None, None, None)


@pytest.mark.parametrize("fn", [jax_dataset_mmap_path, dataset_mmap_path],
                         ids=["jax", "port"])
def test_reuse_mode_keeps_file(tmp_path, monkeypatch, fn):
    monkeypatch.setenv("LIGHTLY_TRAIN_MMAP_REUSE_FILE", "1")
    with fn(tmp_path, tmp_path / "out", False, False) as p:
        p.write_bytes(b"cache")
    assert p.exists()
    with fn(tmp_path, tmp_path / "out", False, False) as p2:
        assert p2 == p
        assert p2.read_bytes() == b"cache"


@pytest.mark.parametrize("fn", [jax_dataset_mmap_path, dataset_mmap_path],
                         ids=["jax", "port"])
def test_different_out_dirs_get_different_files(tmp_path, fn):
    with fn("/data", tmp_path / "a", False, False) as p1:
        with fn("/data", tmp_path / "b", False, False) as p2:
            assert p1 != p2


def test_the_same_path_and_a_suffix_of_its_own(tmp_path):
    with jax_dataset_mmap_path("/data", tmp_path / "out", False,
                               False) as jp:
        with dataset_mmap_path("/data", tmp_path / "out", False, False) as p:
            assert p.stem == jp.stem and p.suffix == SUFFIX
            assert jp.suffix == ".arrow"


# ---- the event tracker -----------------------------------------------------


def _events(monkeypatch, tmp_path, mod, enabled=True):
    monkeypatch.setenv("LIGHTLY_TRAIN_EVENTS_FILE",
                       str(tmp_path / "events.jsonl"))
    if enabled:
        monkeypatch.setenv("LIGHTLY_TRAIN_EVENTS_DISABLED", "0")
    else:
        monkeypatch.delenv("LIGHTLY_TRAIN_EVENTS_DISABLED", raising=False)
    monkeypatch.setenv("LIGHTLY_TRAIN_CACHE_DIR", str(tmp_path / "cache"))
    mod._last_event_time.clear()
    monkeypatch.setattr(mod, "_user_id", None)
    return tmp_path / "events.jsonl"


def _read_events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_events_are_disabled_by_default(tmp_path, monkeypatch):
    path = _events(monkeypatch, tmp_path, tracker, enabled=False)
    tracker.track_training_started(
        task_type="ssl_pretraining", model="dinov2/vittest14",
        method="dinov2", batch_size=8, devices=1, steps=10)
    assert not path.exists()


def test_enabled_events_write_local_jsonl(tmp_path, monkeypatch):
    path = _events(monkeypatch, tmp_path, tracker)
    tracker.track_training_started(
        task_type="semantic_segmentation", model="dinov3/vits16-eomt",
        method="EoMTSemanticSegmentationTrainModel", batch_size=16,
        devices=8, steps=100)
    tracker.track_inference_started(
        task_type="embedding", model="dinov2/vitb14", batch_size=128)
    events = _read_events(path)
    assert [e["event"] for e in events] == [
        "training_started", "inference_started"]
    p = events[0]["properties"]
    assert p["model_name"] == "dinov3/vits16-eomt"
    assert p["steps"] == 100 and p["devices"] == 8
    assert "version" in p and "os" in p
    assert (tmp_path / "cache" / "user_id").read_text() == \
        events[0]["distinct_id"]


def test_events_are_rate_limited_per_name(tmp_path, monkeypatch):
    path = _events(monkeypatch, tmp_path, tracker)
    for _ in range(5):
        tracker.track_event("spam", {"x": 1})
    assert len(_read_events(path)) == 1


def test_event_keys_match_jax(tmp_path, monkeypatch):
    """The same event, the same keys and values in both packages but the
    device fields (the JAX device's platform and kind, here the card's or
    the CPU's) and the package version."""
    args = dict(task_type="ssl_pretraining", model="dinov2/vittest14",
                method="dinov2", batch_size=8, devices=1, steps=3)
    got = []
    for name, mod in (("jax", jax_tracker), ("port", tracker)):
        path = _events(monkeypatch, tmp_path / name, mod)
        mod.track_training_started(**args)
        got.append(_read_events(path))
    (j,), (t,) = got
    assert set(t) == set(j) and t["event"] == j["event"]
    assert set(t["properties"]) == set(j["properties"])
    device = {"platform", "device_kind", "version"}
    assert ({k: v for k, v in t["properties"].items() if k not in device}
            == {k: v for k, v in j["properties"].items() if k not in device})
    assert t["properties"]["platform"] in ("cpu", "gpu")


# ---- the loggers -----------------------------------------------------------


@pytest.fixture(scope="module")
def event_reader():
    """tensorboard's event-file loader (it pulls in TensorFlow once)."""
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader,
    )
    from tensorboard.util import tensor_util

    def read(folder):
        """[(tag, step, value)] of every scalar under ``folder``."""
        out = []
        for path in sorted(folder.rglob("events.out.tfevents.*")):
            for event in EventFileLoader(str(path)).Load():
                for value in event.summary.value:
                    if value.HasField("simple_value"):
                        x = value.simple_value
                    elif value.metadata.plugin_data.plugin_name == "scalars":
                        x = float(tensor_util.make_ndarray(value.tensor))
                    else:
                        continue
                    out.append((value.tag, event.step, np.float32(x)))
        return sorted(out)

    return read


METRICS = [({"train_loss": 1.25, "profiling/step_time": 0.5, "note": "x"},
            1), ({"train_loss": np.float32(0.75), "grad_norm": 3}, 2)]


def test_tensorboard_writes_the_scalars_jax_writes(tmp_path, event_reader):
    for name, mod in (("jax", JM), ("port", M)):
        lg = mod.build_loggers(tmp_path / name, ["tensorboard"])
        lg.log_hyperparams({"lr": 0.1, "model": "dinov2/vittest14"})
        for metrics, step in METRICS:
            lg.log_metrics(metrics, step)
        lg.close()
    got = event_reader(tmp_path / "port" / "tensorboard")
    assert got == event_reader(tmp_path / "jax" / "tensorboard")
    assert [t for t, _, _ in got] == ["grad_norm", "profiling/step_time",
                                      "train_loss", "train_loss"]


class Recorder(types.ModuleType):
    """A stand-in package that records every call made on it or on what
    its calls and attributes return, by dotted path."""

    def __init__(self, name, calls):
        super().__init__(name)
        self.calls = calls

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        return Recorder(f"{self.__name__}.{attr}", self.calls)

    def __call__(self, *args, **kwargs):
        self.calls.append((self.__name__, args, kwargs))
        return Recorder(f"{self.__name__}()", self.calls)


@pytest.mark.parametrize("name", ["wandb", "mlflow"])
def test_wandb_and_mlflow_receive_what_jax_sends(tmp_path, monkeypatch,
                                                 name):
    """Stand-in packages in ``sys.modules``: the same calls in the same
    order (MLflow's keys with ``/`` as ``_``, params cut to 250
    characters)."""
    calls = {}
    for pkg, mod in (("jax", JM), ("port", M)):
        calls[pkg] = []
        monkeypatch.setitem(sys.modules, name, Recorder(name, calls[pkg]))
        lg = mod.build_loggers(tmp_path, {name: {}, "jsonl": None})
        lg.log_hyperparams({"lr": 0.1, "long": "y" * 300})
        for metrics, step in METRICS:
            lg.log_metrics(metrics, step)
        lg.close()
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) == 5  # start, the params, 2 steps, the end
    for path, args, _ in calls["port"]:
        if path == "mlflow.log_metrics":
            assert "profiling_step_time" in args[0] or "grad_norm" in args[0]
        if path == "mlflow.log_params":
            assert len(args[0]["long"]) == 250


@pytest.mark.parametrize("name,blocked", [
    ("tensorboard", {"jax": ["flax.metrics.tensorboard"],
                     "port": ["torch.utils.tensorboard"]}),
    ("wandb", {"jax": ["wandb"], "port": ["wandb"]}),
    ("mlflow", {"jax": ["mlflow"], "port": ["mlflow"]}),
])
def test_an_absent_package_warns_in_both(tmp_path, monkeypatch, caplog,
                                         name, blocked):
    for pkg, mod in (("jax", JM), ("port", M)):
        with monkeypatch.context() as m:
            for module in blocked[pkg]:
                m.setitem(sys.modules, module, None)  # the import fails
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                lg = mod.build_loggers(tmp_path / pkg, [name])
                lg.log_metrics({"train_loss": 1.0}, 1)
                lg.close()
        assert any("logging unavailable" in r.getMessage()
                   for r in caplog.records), pkg
    assert not (tmp_path / "port" / "tensorboard").exists()


@pytest.mark.parametrize("spec", [
    {"jsonl": None}, {"jsonl": {}}, ["jsonl"], [],
    {"jsonl": {"filename": "other.jsonl"}},
])
def test_build_loggers_forms_match_jax(tmp_path, spec):
    for pkg, mod in (("jax", JM), ("port", M)):
        lg = mod.build_loggers(tmp_path / pkg, spec)
        lg.log_metrics({"train_loss": 1.0}, 1)
        lg.close()
    files = {pkg: sorted(p.name for p in (tmp_path / pkg).glob("*"))
             if (tmp_path / pkg).exists() else [] for pkg in ("jax", "port")}
    assert files["port"] == files["jax"]


def test_an_unknown_logger_raises_as_in_jax(tmp_path):
    for mod in (JM, M):
        with pytest.raises(ValueError, match="Unknown logger 'neptune'"):
            mod.build_loggers(tmp_path, {"neptune": {}})


# ---- a run: the profile trace, the system log, the events, the list ------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A profiled DINOv2 vittest14 run of 3 steps (the trace over step 2)
    with events on, then ``embed`` of its export: (out dir, log records,
    events, what the file list held while the run read it)."""
    root = tmp_path_factory.mktemp("run")
    write_images(root / "images")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    seen = []
    real = T.MemoryMappedSequence

    def spy(path):
        seen.append((path, path.exists(),
                     path.with_suffix(".ref_count").read_text(),
                     list(real(path))))
        return real(path)

    pkg = logging.getLogger("lightly_train_tpu_torch")
    pkg.addHandler(handler)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(T, "MemoryMappedSequence", spy)
        m.setenv("LIGHTLY_TRAIN_EVENTS_DISABLED", "0")
        m.setenv("LIGHTLY_TRAIN_EVENTS_FILE", str(root / "events.jsonl"))
        m.setenv("LIGHTLY_TRAIN_CACHE_DIR", str(root / "cache"))
        tracker._last_event_time.clear()
        m.setattr(tracker, "_user_id", None)
        try:
            lt.pretrain(out=str(root / "out"), data=str(root / "images"),
                        model="dinov2/vittest14", method="dinov2",
                        accelerator="cpu", batch_size=4, steps=3,
                        precision="fp32", canonical_size=36, num_workers=2,
                        method_args=SMALL, profile=True, profile_start=1,
                        profile_steps=1)
            lt.embed(out=str(root / "emb.npz"), data=str(root / "images"),
                     checkpoint=str(root / "out" / "exported_models"
                                    / "exported_last"),
                     image_size=28, batch_size=4, accelerator="cpu")
        finally:
            pkg.removeHandler(handler)
    return (root / "out", records, _read_events(root / "events.jsonl"),
            seen)


def test_profile_writes_a_trace_of_the_window(run):
    out, records, _, _ = run
    traces = list((out / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("linear" in n or "addmm" in n or "mm" == n for n in names)
    assert any("Wrote profiler trace" in r.getMessage() for r in records)


def test_the_run_logs_its_system_and_reports_its_events(run):
    _, records, events, _ = run
    systems = [r.getMessage() for r in records
               if r.getMessage().startswith("System: ")]
    assert len(systems) == 2  # pretrain, then embed
    assert all("torch" in s and "CPUs" in s for s in systems)
    assert [e["event"] for e in events] == ["training_started",
                                            "inference_started"]
    p = events[0]["properties"]
    assert (p["task_type"], p["model_name"], p["method"], p["steps"],
            p["devices"]) == ("ssl_pretraining", "dinov2/vittest14",
                              "dinov2", 3, 1)
    assert events[1]["properties"]["batch_size"] == 4


def test_the_run_reads_its_file_list_and_removes_it(run):
    out, _, _, seen = run
    ((path, existed, refs, items),) = seen
    assert existed and refs == "1" and path.suffix == SUFFIX
    assert items == sorted(str(p) for p in (out.parent / "images").iterdir())
    assert not path.exists() and not path.with_suffix(".ref_count").exists()


def test_get_system_information():
    info = get_system_information()
    for key in ("platform", "python", "cpu_count", "torch_version",
                "cuda_version", "device_count", "devices", "numpy_version"):
        assert key in info, key
    assert len(info["devices"]) == info["device_count"]
    assert "memory_gb" in info  # psutil imports here
