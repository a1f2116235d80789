"""The plain layout's wide-row disk cache (<prefix>.serve_plain_w.npz): a miss
writes it, a hit returns the bytes build_wide_rows gives, a file that either
package wrote is a hit for the other, a stale, misshapen or corrupt file is
rebuilt, and a TorchFM made from a hit equals one made from a miss."""

import os
import shutil

import numpy as np
import pytest
import torch

from centrifuger_tpu_torch.build import load_index
from centrifuger_tpu_torch.fm import device as fd
from test_torch_golden import port_index

torch.set_num_threads(1)   # the suite runs in several worker processes

INDEX_FILES = (".fm.npz", ".rowmap.npz", ".tax.npz", ".seqlen.npz", ".meta.json")


@pytest.fixture
def prefix(tmp_path_factory, tmp_path):
    """A fresh copy of the port-built tiny index, with no cache file."""
    src = port_index("tiny", tmp_path_factory)
    for ext in INDEX_FILES:
        shutil.copy(src + ext, str(tmp_path / "idx") + ext)
    return str(tmp_path / "idx")


def cache_of(prefix):
    return prefix + fd.SERVE_CACHE_SUFFIX


def no_build(monkeypatch, module=fd, name="build_wide_rows"):
    """Make a rebuild fail: what is returned then came from the file."""
    def refuse(*a, **k):
        raise AssertionError("the rows were rebuilt")
    monkeypatch.setattr(module, name, refuse)


def test_miss_writes_and_hit_reads(prefix, monkeypatch):
    fm = load_index(prefix)[0]
    assert fm.source_prefix == prefix
    want = fd.build_wide_rows(fm.bwt.decode())
    assert not os.path.exists(cache_of(prefix))
    rows = fd.serve_plain_rows(fd.fm_arrays(fm))
    assert rows.dtype == np.uint32 and rows.tobytes() == want.tobytes()
    assert not [f for f in os.listdir(os.path.dirname(prefix)) if f.endswith(".tmp")]
    with np.load(cache_of(prefix)) as z:
        assert str(z["digest"]) == fd.serve_cache_digest(fd.fm_arrays(fm))
    no_build(monkeypatch)
    hit = fd.serve_plain_rows(fd.fm_arrays(load_index(prefix)[0]))
    assert hit.dtype == np.uint32 and hit.tobytes() == want.tobytes()


def test_jax_file_is_a_hit_for_the_port(prefix, monkeypatch):
    from centrifuger_tpu.build import load_index as jax_load_index
    from centrifuger_tpu.fm.device import serve_plain_rows_np
    jax_rows = serve_plain_rows_np(jax_load_index(prefix)[0])
    assert os.path.exists(cache_of(prefix))
    no_build(monkeypatch)
    rows = fd.serve_plain_rows(fd.fm_arrays(load_index(prefix)[0]))
    assert rows.tobytes() == np.asarray(jax_rows).tobytes()


def test_port_file_is_a_hit_for_jax(prefix, monkeypatch):
    from centrifuger_tpu.build import load_index as jax_load_index
    from centrifuger_tpu.fm import device_fused as jax_device_fused
    from centrifuger_tpu.fm.device import serve_plain_rows_np
    rows = fd.serve_plain_rows(fd.fm_arrays(load_index(prefix)[0]))
    no_build(monkeypatch, jax_device_fused, "build_fused_stream_wide")
    jax_rows = serve_plain_rows_np(jax_load_index(prefix)[0])
    assert np.asarray(jax_rows).tobytes() == rows.tobytes()


def stale(path, rows, digest):
    np.savez(path, rows=rows, digest="0" * 40)


def misshapen(path, rows, digest):
    np.savez(path, rows=rows[:-1], digest=digest)


def as_int32(path, rows, digest):
    """Not stale: an int32 view of the same bytes is a hit."""
    np.savez(path, rows=rows.view(np.int32), digest=digest)


def corrupt(path, rows, digest):
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 not a zip file")


def truncated(path, rows, digest):
    np.savez(path, rows=rows, digest=digest)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


@pytest.mark.parametrize("spoil", [stale, misshapen, as_int32, corrupt, truncated],
                         ids=lambda f: f.__name__)
def test_a_bad_file_is_rebuilt(prefix, monkeypatch, spoil):
    fields = fd.fm_arrays(load_index(prefix)[0])
    want = fd.build_wide_rows(fields["bwt_codes"]())
    spoil(cache_of(prefix), want, fd.serve_cache_digest(fields))
    built = []
    real = fd.build_wide_rows
    monkeypatch.setattr(fd, "build_wide_rows", lambda codes: built.append(1) or real(codes))
    assert fd.serve_plain_rows(fields).tobytes() == want.tobytes()
    assert built == ([] if spoil is as_int32 else [1])
    with np.load(cache_of(prefix)) as z:    # rewritten whole where it was rebuilt
        assert str(z["digest"]) == fd.serve_cache_digest(fields)
        assert z["rows"].tobytes() == want.tobytes()


def test_no_prefix_no_file_and_a_failed_write_keeps_the_rows(prefix, monkeypatch):
    fm = load_index(prefix)[0]
    fields = dict(fd.fm_arrays(fm), source_prefix=None)
    want = fd.build_wide_rows(fm.bwt.decode())
    assert fd.serve_plain_rows(fields).tobytes() == want.tobytes()
    assert not os.path.exists(cache_of(prefix))

    def fail(*a):
        raise OSError("read-only")
    monkeypatch.setattr(os, "replace", fail)
    assert fd.serve_plain_rows(fd.fm_arrays(fm)).tobytes() == want.tobytes()
    assert sorted(os.listdir(os.path.dirname(prefix))) == sorted(
        os.path.basename(prefix) + ext for ext in INDEX_FILES)


def test_torchfm_from_a_hit_equals_one_from_a_miss(prefix, monkeypatch):
    miss = fd.TorchFM.from_index(load_index(prefix)[0], device="cpu")
    assert os.path.exists(cache_of(prefix))
    no_build(monkeypatch)
    hit = fd.TorchFM.from_index(load_index(prefix)[0], device="cpu")
    a, b = dict(miss.named_buffers()), dict(hit.named_buffers())
    assert a.keys() == b.keys() and "rows" in a
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_the_sharded_host_index_uses_the_cache(prefix, monkeypatch):
    """make_classifier's host TorchFM for --shards goes through the cache."""
    from centrifuger_tpu_torch.classify.params import ClassifierParam
    from centrifuger_tpu_torch.cli.classify_cli import make_classifier
    fm, tax, _, _ = load_index(prefix)
    fd.serve_plain_rows(fd.fm_arrays(fm))
    no_build(monkeypatch)
    cl = make_classifier(fm, tax, ClassifierParam(), False, "fused", device="cpu", shards=2)
    assert cl.dev.layout == "plain_sharded"
