"""The non-finite step's capture and its replay (``_debug/``) against the
JAX package's: what the capture holds, that the loop captures the step that
failed (not the one after it), and that the replay of a real run names the
same leaves as the JAX package's replay of the same run. On the CPU at the
``vittest14`` size."""

import numpy as np
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu_torch._commands import train as T
from lightly_train_tpu_torch._commands.train_loop import fit, step_seed
from lightly_train_tpu_torch._debug import NaNGuard, replay_nan_capture
from lightly_train_tpu_torch._debug.nan_guard import (
    replay_capture,
    tree_abs_stats,
)
from lightly_train_tpu_torch.errors import NaNDetectedError
from lightly_train_tpu_torch.methods.base import TrainState
from lightly_train_tpu_torch.models.from_jax import params_from_jax
from torch_fixtures.threads import one_torch_thread  # noqa: F401

SMALL = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
             local_view_count=2, global_image_size=28, local_image_size=14)


def test_nan_guard_captures_and_raises(tmp_path):
    guard = NaNGuard(tmp_path)
    batch = torch.zeros((2, 4, 4, 3), dtype=torch.uint8)
    gen_state = torch.Generator().manual_seed(3).get_state()
    params = {"w": torch.tensor([1.0, float("nan")]), "b": torch.ones(2)}
    with pytest.raises(NaNDetectedError, match="at step 8 ") as err:
        guard.check(False, 7, batch, gen_state, params)
    assert "nan_capture_step7.npz" in str(err.value)
    assert "w: abs_max=1.000e+00 finite=False" in str(err.value)
    assert "b:" not in str(err.value)
    payload = replay_capture(tmp_path / "debug" / "nan_capture_step7.npz")
    assert payload["step"] == 7
    assert payload["batch"].dtype == np.uint8
    assert payload["batch"].shape == (2, 4, 4, 3)
    assert np.array_equal(payload["generator"], gen_state.numpy())
    assert str(payload["generator_device"]) == "cpu"


def test_nan_guard_passes_finite_and_disabled(tmp_path):
    batch = torch.zeros((1, 2, 2, 3), dtype=torch.uint8)
    state = torch.Generator().get_state()
    NaNGuard(tmp_path).check(True, 1, batch, state)
    NaNGuard(tmp_path, enabled=False).check(False, 1, batch, state)
    assert not (tmp_path / "debug").exists()


def test_abs_stats_match_the_jax_packages():
    from lightly_train_tpu._debug.nan_guard import OverflowStats

    tree = {"a": np.array([-3.0, 0.5, np.inf], np.float32),
            "b": np.array([[2.0, -1.0]], np.float32),
            "c": np.array([np.nan], np.float32)}
    ref = OverflowStats.tree_abs_stats(tree)
    got = tree_abs_stats({k: torch.from_numpy(v) for k, v in tree.items()})
    assert set(got) == set(ref)
    for name, (amin, amax, fin) in ref.items():
        np.testing.assert_equal(got[name], (amin, amax, fin))


def test_fit_captures_the_failing_step_and_batch(tmp_path):
    """As the JAX loop (``test_fit_loop_captures_the_failing_step_and_
    batch``): the capture holds the batch and the step number of the step
    whose flag was false, and the generator's state at that step's start,
    though the run stops only once the next step is dispatched."""
    def fake_step(state, batch, generator):
        finite = torch.tensor(state.step != 2)
        state.step += 1
        torch.rand(3, generator=generator)  # the step's draws
        return {"train_loss": torch.tensor(1.0), "finite": finite}

    def batches():
        i = 0
        while True:
            yield torch.full((4, 8, 8, 3), i, dtype=torch.uint8)
            i += 1

    state = TrainState(0, torch.nn.ModuleDict(), {})
    with pytest.raises(NaNDetectedError, match="at step 3 "):
        fit(fake_step, state, batches(), 50, torch.Generator(), seed=11,
            log_every=50, nan_guard=NaNGuard(tmp_path))
    assert state.step == 4  # step 3 (state step 2) checked after step 4
    captures = sorted((tmp_path / "debug").glob("nan_capture_step*.npz"))
    assert [c.name for c in captures] == ["nan_capture_step2.npz"]
    payload = replay_capture(captures[0])
    assert int(payload["step"]) == 2
    assert (payload["batch"] == 2).all()
    expected = torch.Generator().manual_seed(step_seed(11, 2)).get_state()
    assert np.array_equal(payload["generator"], expected.numpy())


def _images(folder):
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        img = rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)
        (folder / f"{i}.ppm").write_bytes(b"P6\n36 36\n255\n" + img.tobytes())


# The leaf set to NaN once state step 3 has run, before the step-3
# checkpoint is written: step 4 (state step 3) is the first non-finite one.
# The augmentation grid is off in both runs (the JAX package draws it with
# eager ops, a fifth of its run; test_torch_checkpoint.py holds it).
POISON = ("student", "block1", "mlp", "fc1", "kernel")
RUN = dict(model="dinov2/vittest14", method="dinov2", batch_size=4, steps=5,
           precision="fp32", canonical_size=36, num_workers=0,
           method_args=SMALL, checkpoint_every=3, log_every=50,
           log_augmentations=False)


def _port_run(out, data, monkeypatch):
    make = T.make_train_step
    name = next(iter(params_from_jax({".".join(POISON): np.zeros((1, 1))})))

    def poisoned(*args, **kwargs):
        step = make(*args, **kwargs)

        def train_step(state, images, generator, **kw):
            metrics = step(state, images, generator, **kw)
            if state.step == 3:
                with torch.no_grad():
                    dict(state.params.named_parameters())[name][0, 0] = (
                        float("nan"))
            return metrics

        return train_step

    monkeypatch.setattr(T, "make_train_step", poisoned)
    with pytest.raises(NaNDetectedError, match="at step 4 ") as err:
        lt.pretrain(out=str(out), data=str(data), accelerator="cpu", **RUN)
    monkeypatch.undo()
    return str(err.value)


def _jax_run(out, data, monkeypatch):
    import jax.numpy as jnp

    import lightly_train_tpu as jlt
    from lightly_train_tpu._commands import train as JT
    from lightly_train_tpu.errors import NaNDetectedError as JaxNaNError

    make = JT.make_train_step

    def poisoned(*args, **kwargs):
        step = make(*args, **kwargs)

        def train_step(state, batch, key):
            state, pending = step(state, batch, key)
            if int(state.step) == 3:
                def poison(tree, path):
                    head, *rest = path
                    if not rest:
                        return {**tree, head: tree[head].at[0, 0].set(
                            jnp.nan)}
                    return {**tree, head: poison(tree[head], rest)}

                state = state.replace(params=poison(state.params, POISON))
            return state, pending

        return train_step

    monkeypatch.setattr(JT, "make_train_step", poisoned)
    with pytest.raises(JaxNaNError, match="at step 3") as err:
        jlt.pretrain(out=str(out), data=str(data), **RUN)
    monkeypatch.undo()
    return str(err.value)


def test_replay_names_the_leaves_the_jax_replay_names(tmp_path, monkeypatch):
    """One run of each package: a parameter set to NaN after state step 3,
    before the step-3 checkpoint, so state step 3 is the first non-finite
    step. Each writes ``debug/nan_capture_step3.npz``, and each replay,
    from that checkpoint, reports a non-finite loss and names the same
    offenders: every gradient, and the one poisoned parameter (the JAX
    names carried to the port's by ``params_from_jax``)."""
    from lightly_train_tpu._debug.replay import replay_nan_capture as jax_replay

    data = tmp_path / "images"
    _images(data)
    said = _port_run(tmp_path / "port", data, monkeypatch)
    jax_said = _jax_run(tmp_path / "jax", data, monkeypatch)
    for out in ("port", "jax"):
        assert [p.name for p in (tmp_path / out / "debug").iterdir()] == [
            "nan_capture_step3.npz"]
    assert "state step 3" in said and "nan_capture_step3.npz" in jax_said

    report = replay_nan_capture(tmp_path / "port")
    ref = jax_replay(tmp_path / "jax")

    def port_name(offender):
        kind, name = offender.split("/", 1)
        jax_path = name.replace("/", ".")
        return f"{kind}/" + next(iter(params_from_jax(
            {jax_path: np.zeros((1, 1) if jax_path.endswith("kernel")
                                else (1,))})))

    assert report["step"] == ref["step"] == 3
    assert report["restored_checkpoint_step"] == 3
    assert report["finite"] is ref["finite"] is False
    assert np.isnan(report["loss"]) and np.isnan(ref["loss"])
    assert report["offenders"] == sorted(port_name(o) for o in ref["offenders"])
    assert [o for o in report["offenders"] if o.startswith("params/")] == [
        "params/student.blocks.1.mlp.fc1.weight"]
