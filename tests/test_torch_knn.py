"""The port's kNN evaluation against the JAX package: ``knn_predict`` and
``knn_accuracy`` on seeded clusters (chunks that force padding, k above the
train count, similarities tied on purpose), and ``evaluate_knn`` of the
same weights exported by each package on a small class folder of PPM
images: the same ``knn_top1``, embeddings within 1e-5, and the val splits
with a missing or an unknown class as in JAX. All on the CPU in fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightly_train_tpu as jlt
import lightly_train_tpu_torch as lt
from lightly_train_tpu._checkpoint.checkpoint import (
    export_model as jax_export_model,
)
from lightly_train_tpu._commands import eval_knn as JK
from lightly_train_tpu.errors import DatasetError as JaxDatasetError
from lightly_train_tpu.utils.knn import knn_accuracy as jax_knn_accuracy
from lightly_train_tpu.utils.knn import knn_predict as jax_knn_predict
from lightly_train_tpu_torch._checkpoint.checkpoint import export_model
from lightly_train_tpu_torch._commands import eval_knn as K
from lightly_train_tpu_torch.errors import DatasetError
from lightly_train_tpu_torch.models.from_jax import variables_from_jax
from lightly_train_tpu_torch.utils.knn import knn_accuracy, knn_predict
from test_torch_export import seeded_variables
from torch_fixtures.threads import one_torch_thread  # noqa: F401

VIT = "dinov2/vittest14"


@pytest.fixture(autouse=True)
def _no_tf32():
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prior


def clusters(seed, n_train, n_query, classes, dim=8, spread=0.6):
    """Train and query points around one centre a class."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((classes, dim))
    ty = rng.integers(0, classes, n_train)
    qy = rng.integers(0, classes, n_query)
    train = centres[ty] + spread * rng.standard_normal((n_train, dim))
    query = centres[qy] + spread * rng.standard_normal((n_query, dim))
    return (train.astype(np.float32), ty.astype(np.int32),
            query.astype(np.float32), qy.astype(np.int32))


def tied(seed):
    """Train points repeated under other labels, and queries on them: every
    query's top similarities tie across classes, and so do the votes."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((6, 4)).astype(np.float32)
    train = np.concatenate([base, base, 2 * base])  # the same directions
    ty = np.concatenate([np.arange(6) % 3, (np.arange(6) + 1) % 3,
                         np.arange(6) % 2]).astype(np.int32)
    query = np.concatenate([base, base[::-1]]).astype(np.float32)
    qy = rng.integers(0, 3, len(query)).astype(np.int32)
    return train, ty, query, qy


# case -> (data, num_classes, k)
CASES = {
    "clusters": (clusters(0, 200, 37, 5), 5, 20),
    "k_above_train": (clusters(1, 9, 11, 3), 3, 20),
    "ties": (tied(2), 3, 4),
    "ties_k1": (tied(3), 3, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_knn_predict_matches_jax(case):
    (train, ty, query, _), classes, k = CASES[case]
    want = np.asarray(jax_knn_predict(
        jnp.asarray(query), jnp.asarray(train), jnp.asarray(ty), classes, k))
    got = knn_predict(torch.from_numpy(query), torch.from_numpy(train),
                      torch.from_numpy(ty), classes, k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case,chunk", [("clusters", 4096), ("clusters", 10),
                                        ("clusters", 16), ("ties", 5),
                                        ("k_above_train", 4)])
def test_knn_accuracy_matches_jax(case, chunk):
    """Chunks of 10 and 16 leave a last chunk of 7 and 5 to pad."""
    (train, ty, query, qy), classes, k = CASES[case]
    want = jax_knn_accuracy(jnp.asarray(query), jnp.asarray(qy),
                            jnp.asarray(train), jnp.asarray(ty), classes, k,
                            chunk_size=chunk)
    got = knn_accuracy(torch.from_numpy(query), torch.from_numpy(qy),
                       torch.from_numpy(train), torch.from_numpy(ty),
                       classes, k, chunk_size=chunk)
    assert got == want


def test_knn_chunked_matches_unchunked():
    """As ``tests/data/test_loader.py::test_knn_chunked_matches_unchunked``."""
    rng = np.random.default_rng(0)
    train = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    train_y = torch.from_numpy(rng.integers(0, 5, 50).astype(np.int32))
    q = torch.from_numpy(rng.normal(size=(23, 8)).astype(np.float32))
    q_y = torch.from_numpy(rng.integers(0, 5, 23).astype(np.int32))
    full_pred = knn_predict(q, train, train_y, num_classes=5, k=7)
    want = float(np.mean(full_pred.numpy() == q_y.numpy()))
    got = knn_accuracy(q, q_y, train, train_y, num_classes=5, k=7,
                       chunk_size=6)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_knn_eval_separable_clusters():
    """As ``tests/test_observability.py::test_knn_eval_separable_clusters``."""
    rng = np.random.default_rng(0)
    c0 = rng.normal(0, 0.1, (50, 8)) + np.array([1] + [0] * 7)
    c1 = rng.normal(0, 0.1, (50, 8)) + np.array([0, 1] + [0] * 6)
    train = torch.tensor(np.concatenate([c0, c1]), dtype=torch.float32)
    labels = torch.tensor([0] * 50 + [1] * 50)
    q0 = rng.normal(0, 0.1, (10, 8)) + np.array([1] + [0] * 7)
    q1 = rng.normal(0, 0.1, (10, 8)) + np.array([0, 1] + [0] * 6)
    query = torch.tensor(np.concatenate([q0, q1]), dtype=torch.float32)
    qlabels = torch.tensor([0] * 10 + [1] * 10)
    acc = knn_accuracy(query, qlabels, train, labels, num_classes=2, k=5)
    assert acc > 0.95


def write_split(root, counts, seed, size=30):
    """PPM images under ``root/<class>``: class c at brightness 40 + 50 c
    plus noise."""
    rng = np.random.default_rng(seed)
    for c, (name, n) in enumerate(counts.items()):
        folder = root / name
        folder.mkdir(parents=True)
        for i in range(n):
            img = np.clip(40 + 50 * c + rng.integers(-30, 30, (size, size, 3)),
                          0, 255).astype(np.uint8)
            (folder / f"{i}.ppm").write_bytes(
                f"P6\n{size} {size}\n255\n".encode() + img.tobytes())


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """The same weights as a JAX and a port artifact, and the splits:
    train (4 classes), val (the 4), val without class ``c``, and val with
    a class that train lacks."""
    root = tmp_path_factory.mktemp("knn")
    variables = seeded_variables(VIT, seed=3)
    jax_export_model(root / "jax", VIT, variables["params"])
    export_model(root / "port", VIT, variables_from_jax(variables))
    names = ["a", "b", "c", "d"]
    write_split(root / "train", dict.fromkeys(names, 5), 0)
    write_split(root / "val", dict.fromkeys(names, 3), 1)
    write_split(root / "val_missing", {"a": 3, "b": 3, "d": 3}, 2)
    write_split(root / "val_unknown", {"a": 2, "e": 2}, 3)
    return root


def spy(monkeypatch, module, calls):
    """Records the arguments of ``module.knn_accuracy``."""
    real = module.knn_accuracy

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "knn_accuracy", recorded)


@pytest.mark.parametrize("val", ["val", "val_missing"])
def test_evaluate_knn_matches_jax(monkeypatch, folders, val):
    """The same accuracy from the same weights, embeddings within 1e-5;
    batches of 8 pad the last of each split. Without class ``c`` in val
    the labels keep the train split's indices."""
    j_calls, t_calls = [], []
    spy(monkeypatch, JK, j_calls)
    spy(monkeypatch, K, t_calls)
    kwargs = dict(data={"train": str(folders / "train"),
                        "val": str(folders / val)},
                  image_size=28, batch_size=8, k=3)
    want = jlt.evaluate_knn(checkpoint=str(folders / "jax"), **kwargs)
    got = lt.evaluate_knn(checkpoint=str(folders / "port"), accelerator="cpu",
                          **kwargs)
    assert got == want
    (j_args, j_kw), = j_calls
    (t_args, t_kw), = t_calls
    assert t_kw == j_kw
    for j, t in zip(j_args, t_args):
        j = np.asarray(j)
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-5)
    val_labels = t_args[1].numpy()
    assert (2 in val_labels) == (val == "val")
    assert set(val_labels) <= {0, 1, 2, 3}


def test_an_unknown_val_class_is_refused_as_in_jax(folders):
    kwargs = dict(data={"train": str(folders / "train"),
                        "val": str(folders / "val_unknown")},
                  image_size=28, batch_size=8)
    with pytest.raises(JaxDatasetError, match=r"Classes \['e'\]"):
        jlt.evaluate_knn(checkpoint=str(folders / "jax"), **kwargs)
    with pytest.raises(DatasetError, match=r"Classes \['e'\]"):
        lt.evaluate_knn(checkpoint=str(folders / "port"), accelerator="cpu",
                        **kwargs)
