"""The port's data layer against the JAX package's: the same synthetic LDCT,
latent and MNIST roots built through both ``build_dataset_from_config``
give bitwise-equal samples, equal records, lot ids, ``img_id``,
``img_path`` and cache paths; tensor caches written by either package read
bitwise in the other; the split-file reader types cells as pandas does; the
sampling dataset picks the same eval cache namespace and subset.

The LDCT roots hold ``.npy`` volumes of HU values (4 slices of 8x8, resized
to 6x6 in some configs). Headerless and headed split files, a case column of
``001``, an empty cell (in a path column and in the case column), a case
whose two volumes have different slice counts, DICOM-style directories of
slices, ``window_size`` 1 and 3, and ``dataset.json`` files naming
``datasets.ldct:LDCTDataset`` and ``fmdm_tpu.data.latent:LatentDataset``.
"""

import ast
import io
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from fmdm_tpu.data import dataset_utils as jdu
from fmdm_tpu.data import io as jio
from fmdm_tpu.data import ldct as jldct
from fmdm_tpu.data import mnist as jmnist
from fmdm_tpu.sample import sampling_utils as jsu
from fmdm_tpu_torch.data import base as tbase
from fmdm_tpu_torch.data import dataset_utils as tdu
from fmdm_tpu_torch.data import io as tio
from fmdm_tpu_torch.data import ldct as tldct
from fmdm_tpu_torch.data import mnist as tmnist
from fmdm_tpu_torch.sample import sampling_utils as tsu

REPO = Path(__file__).resolve().parents[1]
SLICES, SIDE = 4, 8


def _volume(rng, depth=SLICES):
    return rng.uniform(-1100, 3200, (depth, SIDE, SIDE)).astype(np.float32)


def _write_ldct_root(root: Path, *, header: bool, rows, seed=0):
    """A data root of ``.npy`` volumes under ``vol/`` and the split files;
    ``rows`` are (case, sdct depth, ldct depth), a depth of None writing an
    empty cell, a depth given as ("dir", n) a directory of n 2-D slices."""
    rng = np.random.default_rng(seed)
    lines = ["Case\tSDCT\tLDCT"] if header else []
    for i, (case, *depths) in enumerate(rows):
        cells = [case]
        for kind, depth in zip(("sdct", "ldct"), depths):
            if depth is None:
                cells.append("")
                continue
            rel = f"vol/{kind}_{i}"
            if isinstance(depth, tuple):
                (root / rel).mkdir(parents=True)
                for s, image in enumerate(_volume(rng, depth[1])):
                    np.save(root / rel / f"{s:03d}.npy", image)
            else:
                rel += ".npy"
                (root / rel).parent.mkdir(parents=True, exist_ok=True)
                np.save(root / rel, _volume(rng, depth))
            cells.append(rel)
        lines.append("\t".join(cells))
    for split in ("train.txt", "test.txt"):
        (root / split).write_text("\n".join(lines) + "\n")
    return root


LDCT_JSON = {"dataset_class": "datasets.ldct:LDCTDataset",
             "preprocess_kwargs": {"MIN_B": -1024, "MAX_B": 3072, "slope": 1.0, "intersept": -1024}}

# (name, header, rows, window_size, img_size)
LDCT_ROOTS = [
    ("headerless 001", False, [("001", 4, 4), ("002", 4, 4)], 1, None),
    ("headed 001", True, [("001", 4, 4), ("002", 4, 4)], 1, 6),
    ("empty path cell", False, [("001", 4, None), ("002", 4, 4), ("003", 4, 4)], 3, None),
    ("empty case cell", False, [("", 4, 4), ("2", 4, 4), ("3", 4, 4)], 1, None),
    ("mismatched case", True, [("C1", 4, 3), ("C2", 4, 4)], 1, 6),
    ("window 3", True, [("C1", 4, 4), ("C2", 4, 4)], 3, None),
    ("directories window 3", True, [("C1", ("dir", 4), ("dir", 4)), ("C2", 4, 4)], 3, None),
    ("directories window 1", False, [("001", ("dir", 3), ("dir", 3))], 1, None),
]


def _training_cfg(root, window, img_size, **kw):
    return {"data_root": str(root), "dataset": "ldct", "conditioning": "concatenate",
            "load_ldct": True, "img_size": img_size, "slice_count": window, "norm": True,
            "use_tensor_cache": True, **kw}


def _build_both(tmp_path, name, header, rows, window, img_size, dataset_json=LDCT_JSON, **kw):
    root = _write_ldct_root(tmp_path / "root", header=header, rows=rows)
    (root / "dataset.json").write_text(json.dumps(dataset_json))
    cfg = _training_cfg(root, window, img_size, **kw)
    run = tmp_path / "run"
    run.mkdir(exist_ok=True)
    cfg_path = run / "train_config.json"
    return (tdu.build_dataset_from_config(dict(cfg), {}, train=False, cfg_path=cfg_path),
            jdu.build_dataset_from_config(dict(cfg), {}, train=False, cfg_path=cfg_path))


def _pandas2_lot_id(df, case_column, number_column):
    """JAX's ``lot_id`` as pandas 2 ran it: a str written into a numeric
    case column upcast the column. pandas 3 refuses the write (TypeError),
    so under pandas 3 the JAX package fails on a directory case with a
    numeric case id; the port gives pandas 2's result."""
    return _jax_lot_id(df.astype({case_column: object}), case_column, number_column)


_jax_lot_id = jldct.lot_id


def _cache_paths(ds, row):
    return [tdu.cache_path_for_entry(ds.base_path, ds.cache_root, row[key],
                                     *ds._cache_info(row[key], row, key))
            for key in (ds.target_key, ds.conditioning_key)]


def _assert_same_dataset(got, want):
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) and got.data == want.data
    for i in range(len(want)):
        a, b = got[i], want[i]
        for key in ("target", "image"):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), (i, key)
        for key in ("img_id", "img_path", "img_size"):
            assert a[key] == b[key] and type(a[key]) is type(b[key]), (i, key, a[key], b[key])
        assert _cache_paths(got, got.data[i]) == _cache_paths(want, want.data[i])


@pytest.mark.parametrize("name,header,rows,window,img_size", LDCT_ROOTS, ids=[r[0] for r in LDCT_ROOTS])
def test_ldct_dataset_matches_jax(tmp_path, monkeypatch, name, header, rows, window, img_size):
    monkeypatch.setattr(jldct, "lot_id", _pandas2_lot_id)
    got, want = _build_both(tmp_path, name, header, rows, window, img_size)
    _assert_same_dataset(got, want)
    ids = [r["Case"] for r in got.data]
    if name == "headerless 001":
        assert ids[0] == 1 and got[0]["img_id"] == 1   # pandas' int inference
    if name == "headed 001":
        assert ids[0] == "001"                          # the header row made the column str
    if name == "empty case cell":
        assert ids == [2.0] * SLICES + [3.0] * SLICES    # int column with a missing cell: float
    if name == "empty path cell":
        assert {r["Case"] for r in got.data} == {2, 3}
    if name == "mismatched case":
        assert {r["Case"] for r in got.data} == {"C2"}
    if name == "directories window 3":
        assert ids[:2] == ["IC1S0F000T002C3", "IC1S1F001T003C3"]
    if name == "directories window 1":
        assert ids == [1, 1, 1]   # single files: no lot name


def test_numeric_case_with_directory_windows_needs_pandas2_in_jax(tmp_path):
    """Under pandas 3 the JAX package cannot name the lot of a numeric case
    id (see ``_pandas2_lot_id``); the port names it I<case>S…."""
    rows = [("001", ("dir", 4), ("dir", 4))]
    root = _write_ldct_root(tmp_path / "root", header=False, rows=rows)
    got = tldct.LDCTDataset(str(root), train=False, window_size=3, load_ldct=True)
    assert [r["Case"] for r in got.data] == ["I1S0F000T002C3", "I1S1F001T003C3"]
    if int(pd.__version__.split(".")[0]) >= 3:
        with pytest.raises(TypeError):
            jldct.LDCTDataset(str(root), train=False, window_size=3, load_ldct=True)


def test_attention_dataset_matches_jax(tmp_path):
    attention = dict(LDCT_JSON, dataset_class="datasets.ldct:LDCTAttentionDataset")
    got, want = _build_both(tmp_path, "attention", True, [("C1", 4, 4)], 1, None,
                            dataset_json=attention)
    _assert_same_dataset(got, want)
    assert got[0]["image"].min() < 0   # conditioning skips the HU window


def _write_latent_root(root: Path):
    rng = np.random.default_rng(3)
    rows = []
    for i in range(3):
        np.save(root / f"t{i}.npy", rng.standard_normal((4, 4, 4)).astype(np.float32) * 3)
        np.save(root / f"c{i}.npy", rng.standard_normal((4, 4, 4)).astype(np.float32) * 3)
        rows.append(f"case{i}\tt{i}.npy\tc{i}.npy")
    (root / "test.txt").write_text("Case\ttarget\tconditioning\n" + "\n".join(rows) + "\n")
    (root / "dataset.json").write_text(json.dumps(
        {"dataset_class": "fmdm_tpu.data.latent:LatentDataset", "use_tensor_cache": False}))


def test_latent_dataset_from_the_jax_class_name_matches_jax(tmp_path):
    root = tmp_path / "latent"
    root.mkdir()
    _write_latent_root(root)
    cfg = {"data_root": str(root), "conditioning": "attention"}
    got = tdu.build_dataset_from_config(dict(cfg), {}, train=False)
    want = jdu.build_dataset_from_config(dict(cfg), {}, train=False)
    assert type(got).__module__ == "fmdm_tpu_torch.data.latent"
    _assert_same_dataset(got, want)
    assert not np.array_equal(got[0]["image"], got[0]["target"])   # the conditioning column
    with pytest.raises(ImportError, match="JAX package"):
        tdu._import_symbol("fmdm_tpu.models.factories:DiffusionUNetFactory")


@pytest.mark.parametrize("train", [True, False])
def test_mnist_synthetic_fallback_matches_jax(tmp_path, train):
    got = tmnist.MNISTDataset(str(tmp_path), train=train, img_size=16)
    want = jmnist.MNISTDataset(str(tmp_path), train=train, img_size=16)
    assert got.synthetic and want.synthetic and len(got) == len(want)
    assert np.array_equal(got.images, want.images) and np.array_equal(got.labels, want.labels)
    assert got.data == want.data
    for i in (0, 7, len(want) - 1):
        a, b = got[i], want[i]
        assert np.array_equal(a["target"], b["target"]) and a["label"] == b["label"]
        assert a["img_id"] == b["img_id"] and a["img_size"] == b["img_size"]


def test_mnist_reads_idx_and_npz_like_jax(tmp_path):
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (6, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 6, dtype=np.uint8)
    np.savez(tmp_path / "mnist.npz", x_train=images, y_train=labels, x_test=images[:2],
             y_test=labels[:2])
    raw = tmp_path / "idx" / "MNIST" / "raw"
    raw.mkdir(parents=True)
    import gzip
    import struct
    with gzip.open(raw / "t10k-images-idx3-ubyte.gz", "wb") as fh:
        fh.write(struct.pack(">IIII", 0x803, 6, 28, 28) + images.tobytes())
    (raw / "t10k-labels-idx1-ubyte").write_bytes(struct.pack(">II", 0x801, 6) + labels.tobytes())
    for root, train in ((tmp_path, True), (tmp_path, False), (tmp_path / "idx", False)):
        got = tmnist.MNISTDataset(str(root), train=train, img_size=28)
        want = jmnist.MNISTDataset(str(root), train=train, img_size=28)
        assert not got.synthetic and np.array_equal(got.images, want.images)
        assert np.array_equal(got.labels, want.labels)
        assert np.array_equal(got[1]["target"], want[1]["target"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tensor_cache_reads_bitwise_in_the_other_package(tmp_path, writer):
    rows = [("001", 4, 4), ("002", 4, 4)]
    got, want = _build_both(tmp_path, "cache", False, rows, 3, 6, save_tensor_cache=True,
                            tensor_cache_subdir="cache")
    first = got if writer == "port" else want
    other = want if writer == "port" else got
    samples = [first[i] for i in range(len(first))]
    if writer == "jax":
        first.flush_tensor_cache_writes()
    files = sorted((tmp_path / "root" / "cache").rglob("*.pt"))
    assert len(files) == 2 * len(first)
    for path in files:
        assert np.array_equal(tdu.load_tensor_cache(path), jdu.load_tensor_cache(path))
    # the other package reads from the cache: change the volumes under it
    for vol in (tmp_path / "root" / "vol").glob("*.npy"):
        np.save(vol, np.zeros((SLICES, SIDE, SIDE), np.float32))
    for i, sample in enumerate(samples):
        again = other[i]
        for key in ("target", "image"):
            assert np.array_equal(again[key], sample[key]), (i, key)
    arr = np.arange(12, dtype=np.float64).reshape(3, 4)
    for save, load in ((tdu.save_tensor_cache, jdu.load_tensor_cache),
                       (jdu.save_tensor_cache, tdu.load_tensor_cache)):
        save(arr, tmp_path / "x" / "a.pt")
        back = load(tmp_path / "x" / "a.pt")
        assert back.dtype == np.float32 and np.array_equal(back, arr)


SPLIT_CELLS = [
    "001\ta\tb\n002\tc\td\n",
    "Case\tSDCT\tLDCT\n001\ta\tb\n",
    "001\ta\tb\n\tc\td\n003\te\tf\n",
    "1\tNone\tb\n2\tc\tNA\n3\tn/a\tx\n4\tnull\ty\n",
    "1.5\ta\tb\n2\tc\td\n",
    "1e3\t.5\tinf\n2\t1.\t-Infinity\n",
    "True\ta\tb\nfalse\tc\td\n",
    "True\ta\tb\n1\tc\td\n",
    " 2\ta\tb\n3 \tc\td\n",
    "+3\t-0\t0x10\n4\t5\t1_000\n",
    EXTRA_FIELDS := "1\ta\n2\tb\tc\n",
    "1\ta\tb\n\n2\tc\td\n",
    "\"001\"\t\"a b\"\tc\n",
    "99999999999999999999\ta\tb\n1\tc\td\n",
]


@pytest.mark.parametrize("text", SPLIT_CELLS, ids=range(len(SPLIT_CELLS)))
@pytest.mark.parametrize("names", [("Case", "SDCT", "LDCT"), None])
def test_split_file_reader_types_cells_as_pandas(tmp_path, text, names):
    """The rows after ``dropna``, and the header drop of BaseDataset. A row
    with more fields than the header names is refused, where pandas would
    take the extra leading fields as an index."""
    path = tmp_path / "split.txt"
    path.write_text(text)
    if names is None and text == EXTRA_FIELDS:
        with pytest.raises(ValueError, match="3 fields"):
            tbase.read_split_rows(path, names)
        return
    df = pd.read_csv(io.StringIO(text), sep="\t", names=names)
    if names is not None and len(df) and tuple(str(v) for v in df.iloc[0]) == tuple(names):
        df = df.iloc[1:].reset_index(drop=True)
    want = df.dropna().to_dict("records")
    got = tbase.complete_rows(tbase.read_split_rows(path, names))
    assert got == want
    assert [[type(v) for v in r.values()] for r in got] == [[type(v) for v in r.values()] for r in want]


def test_split_file_with_extra_fields_is_refused(tmp_path):
    (tmp_path / "s.txt").write_text("1\ta\tb\tc\n")
    with pytest.raises(ValueError, match="4 fields"):
        tbase.read_split_rows(tmp_path / "s.txt", ("Case", "SDCT", "LDCT"))


def test_lot_id_matches_jax():
    rows = [{"case": "C1", "files": ["a/001.npy", "a/003.npy"]},
            {"case": 7, "files": "a/x.npy"}, {"case": 8, "files": ["b/010.dcm"]},
            {"case": "C2", "files": []}]
    want = _pandas2_lot_id(pd.DataFrame(rows), "case", "files").to_dict("records")
    assert tldct.lot_id(rows, "case", "files") == want
    assert rows[0]["case"] == "C1"   # the input rows are left as they are


def test_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "vol.npy", rng.random((5, 3, 3), dtype=np.float32))
    np.save(tmp_path / "img.npy", rng.random((3, 3), dtype=np.float32))
    (tmp_path / "d").mkdir()
    for i in range(4):
        np.save(tmp_path / "d" / f"{i}.npy", np.full((2, 2), i, np.float32))
    for window in (-1, 0, 1, 2, 3, 6):
        for name in ("vol.npy", "img.npy"):
            assert tdu.split_volume_entry(str(tmp_path / name), window) == \
                jdu.split_volume_entry(str(tmp_path / name), window)
        assert tdu.consecutive_paths(str(tmp_path / "d"), window) == \
            jdu.consecutive_paths(str(tmp_path / "d"), window)
        assert tdu.resolve_entry(tmp_path, "d", window) == jdu.resolve_entry(tmp_path, "d", window)
    for entry, idx, count in (("a/b.npy", None, 1), ("a/b.npy", 2, 3), (["x/y.dcm"], 1, 2),
                              ({"path": str(tmp_path / "v.npy")}, 0, 1),
                              ({"paths": ["p/q.npy"]}, None, 1), ("/elsewhere/z.npy", 1, 4), ([], 0, 1)):
        assert tdu.cache_path_for_entry(tmp_path, tmp_path / "c", entry, idx, count) == \
            jdu.cache_path_for_entry(tmp_path, tmp_path / "c", entry, idx, count)
    for arr in (rng.random((4, 4)), rng.random((1, 4, 4)), rng.random((3, 4, 4)) * 2 - 0.5,
                rng.random((2, 4, 4))):
        got, want = tdu.to_2d_image(arr), jdu.to_2d_image(arr)
        assert (got is None and want is None) or np.array_equal(got, want)
    x = rng.random((2, 5, 7))
    for size in ((3, 4), (5, 7), (7,)):
        assert np.array_equal(tio.resize_array(x, size), jio.resize_array(x, size))
    assert np.array_equal(tio.load(tmp_path / "d")["Image"], jio.load(tmp_path / "d")["Image"])
    files = [tmp_path / "d" / f"{i}.npy" for i in (3, 1, 2, 0)] * 2
    assert np.array_equal(tio.load(files)["Image"], jio.load(files)["Image"])
    torch.save(torch.arange(6.0).reshape(2, 3), tmp_path / "t.pt")
    np.savez(tmp_path / "z.npz", a=np.eye(3))
    for name in ("t.pt", "z.npz", "vol.npy"):
        assert np.array_equal(tio.load(tmp_path / name)["Image"], jio.load(tmp_path / name)["Image"])


@pytest.mark.parametrize("cfg", [
    {"dataset": "mnist"}, {"dataset": "LDCT"}, {"dataset": "ldct", "conditioning": "attention"},
    {"split_file": "x/mnist_test.txt"}, {"split_file": "LDCT/PixelAttention/t.txt"},
    {"split_file": "ldct_EncodedDataset.txt"}, {"dataset": "ldct", "split_file": "mnist.txt"},
    {"dataset": "other"}, {"conditioning": "attention", "split_file": "ldct.txt"},
])
def test_dataset_class_inference_and_kwargs_match_jax(cfg):
    assert tdu._infer_dataset_class(cfg, {}) == jdu._infer_dataset_class(cfg, {})
    training = {"data_root": "/d", "tensor_cache_subdir": "c", "slice_count": 3, "img_size": 8,
                "conditioning": cfg.get("conditioning", "concatenate"), "norm": False, "download": 1}
    for keys in (["self", "file_path", "train", "window_size", "cache_subdir", "conditioning",
                  "img_size", "norm", "download", "missing"], ["root", "window_size"]):
        assert tdu._build_dataset_kwargs(training, False, keys) == \
            jdu._build_dataset_kwargs(training, False, keys)


@pytest.mark.parametrize("subdir,data_txt", [(None, None), ("cache", "test.txt"), ("x_eval", None),
                                             ("cache", None)])
def test_sampling_dataset_picks_the_same_eval_cache_and_subset(tmp_path, subdir, data_txt):
    root = _write_ldct_root(tmp_path / "root", header=True, rows=[("C1", 4, 4), ("C2", 4, 4)])
    (root / "dataset.json").write_text(json.dumps(LDCT_JSON))
    training = _training_cfg(root, 1, None, split_file="train.txt")
    if subdir is not None:
        training["tensor_cache_subdir"] = subdir
    cfg = {"training": training, "model": {}, "__config_path__": str(tmp_path / "train_config.json")}
    for evaluate in (True, False):
        got = tsu.build_sampling_dataset(cfg, data_txt, evaluate=evaluate,
                                         save_tensor_cache_override=evaluate)
        want = jsu.build_sampling_dataset(cfg, data_txt, evaluate=evaluate,
                                          save_tensor_cache_override=evaluate)
        assert got.cache_root == want.cache_root and got.split_file == want.split_file
        assert got.save_tensor_cache == want.save_tensor_cache and got.data == want.data
        assert tsu._eval_cache_subdir(subdir) == jsu._eval_cache_subdir(subdir)
        for num in (None, 3, 5, 8, 100):
            assert tsu.resolve_sample_indices(got, num, seed=7) == \
                jsu.resolve_sample_indices(want, num, seed=7)
    assert tsu.build_tensor_cache_from_config(cfg, None, 3, 7, 5) == \
        jsu.build_tensor_cache_from_config(cfg, None, 3, 7, 5) == 5


def test_ldct_writers_match_jax(tmp_path):
    rows = [("C1", 4, 4)]
    got, want = _build_both(tmp_path, "writers", True, rows, 1, None)
    rng = np.random.default_rng(9)
    for shape in ((1, SIDE, SIDE), (SIDE, SIDE), (3, SIDE, SIDE), (1, 1, SIDE, SIDE), (2, 2, 2, 2)):
        out = rng.random(shape, dtype=np.float32)
        for ds, where in ((got, "port"), (want, "jax")):
            tdu.save_output_tensor(ds, ds.data[1], ds.target_key, out, tmp_path / where)
    port = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    jax_ = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert port == jax_ and port
    for rel in port:
        a, b = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.suffix == ".pt":
            assert np.array_equal(tdu.load_tensor_cache(a), jdu.load_tensor_cache(b))
        elif rel.suffix == ".npy":
            assert np.array_equal(np.load(a), np.load(b))
        else:
            assert np.array_equal(tio.load_image(a)["Image"], tio.load_image(b)["Image"])


_OPTIONAL = {"PIL", "tqdm", "pydicom"}


def _optional_imports_outside_try(tree):
    """Imports of the optional packages not in the body of a ``try``."""
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            for stmt in node.body:
                inside.update(id(n) for n in ast.walk(stmt))
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
        if any(n.split(".")[0] in _OPTIONAL for n in names) and id(node) not in inside:
            yield node.lineno


@pytest.mark.parametrize("path", sorted((REPO / "fmdm_tpu_torch" / "data").glob("*.py"))
                         + sorted((REPO / "fmdm_tpu_torch" / "sample").glob("*.py")),
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_no_pandas_and_optional_imports_only_inside_try(path):
    tree = ast.parse(path.read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "pandas" not in roots
    assert list(_optional_imports_outside_try(tree)) == []
