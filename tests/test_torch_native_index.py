"""The port's partitioned mmap feature index (data/native_index.py over
native/index_store.cpp) on the CPU: the reference's round trips through the
native and the pure-Python reader, store files byte for byte the
reference's for the same ``IndexMap``, each package reading the other's
store, the library's build rule (a build of its own name, then
``os.replace``), and the explicit native reader that raises rather than
fall back.
"""

import filecmp
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from photon_tpu.data import native_index as jni
from photon_tpu.data.index_map import IndexMap as JIndexMap

from photon_tpu_torch.data import native_index
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.data.native_index import NativeIndexMap, NativeIndexMapBuilder, build_native_lib

REPO = Path(__file__).resolve().parent.parent
KEYS = [f"feat{i}\x01term{i % 3}" for i in range(1000)]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("idx")
    imap = IndexMap.build(KEYS, add_intercept=True)
    NativeIndexMapBuilder(str(d), num_partitions=4).build(imap)
    return str(d), imap


@pytest.mark.parametrize("use_native", [True, False])
def test_round_trip(store, use_native):
    d, imap = store
    nim = NativeIndexMap(d, use_native=use_native)
    assert nim.is_native == use_native
    assert len(nim) == len(imap)
    for key, idx in list(imap.items())[:200]:
        assert nim.get_index(key) == idx
        assert nim.get_feature_name(idx) == key
    assert nim.get_index("not-a-feature") == -1
    assert nim.get_feature_name(len(imap) + 5) is None
    nim.close()


def test_batched_lookup_native(store):
    d, imap = store
    nim = NativeIndexMap(d, use_native=True)
    keys = [k for k, _ in list(imap.items())[:500]] + ["missing1", "missing2"]
    np.testing.assert_array_equal(nim.get_indices(keys), np.array([imap.get_index(k) for k in keys], np.int64))
    nim.close()


def test_native_lib_builds():
    so = build_native_lib()
    assert os.path.exists(so) and Path(so).parent == native_index.BUILD_DIR


def test_native_and_pure_agree(store):
    d, _ = store
    native = NativeIndexMap(d, use_native=True)
    pure = NativeIndexMap(d, use_native=False)
    for key in KEYS[::37]:
        assert native.get_index(key) == pure.get_index(key)
    np.testing.assert_array_equal(native.get_indices(KEYS[:64]), pure.get_indices(KEYS[:64]))
    native.close()
    pure.close()


def test_source_is_the_reference_copy():
    ours = native_index.SOURCE.read_text()
    theirs = (REPO / "photon_tpu" / "native" / "index_store.cpp").read_text()
    assert ours.split("\n", 1)[1] == theirs


@pytest.mark.parametrize("parts", [1, 3, 4])
def test_store_files_byte_identical_to_reference(tmp_path, parts):
    """The same index map gives the same files, byte for byte."""
    imap, jimap = IndexMap.build(KEYS, add_intercept=True), JIndexMap.build(KEYS, add_intercept=True)
    assert dict(imap.items()) == dict(jimap.items())
    NativeIndexMapBuilder(str(tmp_path / "port"), parts).build(imap)
    jni.NativeIndexMapBuilder(str(tmp_path / "ref"), parts).build(jimap)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "ref", tmp_path / "port", names, shallow=False)
    assert mismatch == [] and errors == [] and len(match) == parts + 2


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_store(tmp_path, writer):
    imap = IndexMap.build(KEYS, add_intercept=True)
    if writer == "port":
        NativeIndexMapBuilder(str(tmp_path), 3).build(imap)
        readers = [jni.NativeIndexMap(str(tmp_path), use_native=False)]
    else:
        jni.NativeIndexMapBuilder(str(tmp_path), 3).build(JIndexMap.build(KEYS, add_intercept=True))
        readers = [NativeIndexMap(str(tmp_path), use_native=True), NativeIndexMap(str(tmp_path), use_native=False)]
    for r in readers:
        for key, idx in imap.items():
            assert r.get_index(key) == idx and r.get_feature_name(idx) == key
        r.close()


def test_concurrent_build_leaves_no_partial_library(tmp_path):
    """Three processes build into one empty directory at once: each loads a
    whole library, and no temporary file is left behind."""
    build = tmp_path / "build"
    code = (
        "import sys, time\n"
        "from pathlib import Path\n"
        "from photon_tpu_torch.data import native_index as ni\n"
        "ni.BUILD_DIR = Path(sys.argv[1])\n"
        "while time.time() < float(sys.argv[2]):\n"
        "    time.sleep(0.001)\n"
        "so = ni.build_native_lib()\n"
        "ni._load_lib(so)\n"
        "print(Path(so).name)\n"
    )
    import time

    start = str(time.time() + 2.0)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build), start], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    names = {o[0].strip() for o in outs}
    assert len(names) == 1
    assert sorted(os.listdir(build)) == sorted(names)


def test_explicit_native_reader_raises_when_the_build_fails(store, tmp_path, monkeypatch, caplog):
    """``use_native=True`` never falls back; the default reader takes the
    pure one and logs why."""
    d, imap = store
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_index, "SOURCE", bad)
    monkeypatch.setattr(native_index, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native_index.NativeLibraryError, match="g\\+\\+ exited"):
        NativeIndexMap(d, use_native=True)
    with caplog.at_level(logging.INFO, logger="photon_tpu_torch"):
        nim = NativeIndexMap(d)
    assert not nim.is_native and nim.get_index(KEYS[5]) == imap.get_index(KEYS[5])
    assert any("pure-Python reader" in r.message for r in caplog.records)
    assert not list((tmp_path / "build").glob("*.tmp"))
    nim.close()


def test_default_reader_is_native_and_logged(store, caplog):
    d, _ = store
    with caplog.at_level(logging.INFO, logger="photon_tpu_torch"):
        nim = NativeIndexMap(d)
    assert nim.is_native
    assert any("native reader" in r.message for r in caplog.records)
    nim.close()
