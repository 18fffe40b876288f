"""The port's out-of-core passes: the streamed preprocess and postprocess
against the port's in-memory steps and the JAX package's streamed
functions, their slab loops over an in-memory source and sink,
``streamed_percentiles`` against ``numpy.percentile``, and the memory
bound of a streamed POCS and a streamed postprocess in child processes.

Tolerances: the slab loops run the in-memory chain's operations on each
slab, so on the CPU they are held bit-equal to the in-memory steps. The
JAX streamed functions are held to ``TOL`` = 1e-5·max|JAX| (the JAX side's
matmul DFTs and float32 sums in another order, as tests/test_torch_stage2
holds the in-memory steps). ``streamed_percentiles`` is exact.

The JAX package's own memory tests cap the child's address space, under
which jax cannot start here (ROADMAP queue 3 #2). These children import
no jax, and the bound is their peak resident set's growth after their
imports and a warm-up run (``VmHWM``, reset through ``clear_refs``)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io.ncio import read_cube as jread_cube
from pseudo_3d_interpolation_tpu.pipeline import postprocess as jpost
from pseudo_3d_interpolation_tpu.pipeline.preprocess import \
    preprocess as jpreprocess
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.io.ncio import (CubeFile, CubeWriter,
                                                   read_cube, write_cube)
from pseudo_3d_interpolation_torch.pipeline import postprocess as post
from pseudo_3d_interpolation_torch.pipeline import preprocess as pre
from torch_helpers import MemoryCube, MemoryStore

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
CPU = "cpu"


def _time_cube(n_il=12, n_xl=10, ns=64, seed=3, extra=False):
    """JAX tests/test_out_of_core.py's time cube, with ``extra``
    variables to ride through: one on (iline, xline, twt), one on
    (xline,) alone."""
    rng = np.random.default_rng(seed)
    amp = rng.normal(size=(n_il, n_xl, ns)).astype(np.float32)
    data_vars = {"amp": (("iline", "xline", "twt"), amp),
                 "fold": (("iline", "xline"),
                          np.ones((n_il, n_xl), np.int32))}
    if extra:
        data_vars["quality"] = (("iline", "xline", "twt"),
                                rng.uniform(size=amp.shape).astype(
                                    np.float32))
        data_vars["offset"] = (("xline",), np.arange(n_xl, dtype=np.int16))
    return Cube(coords={"iline": np.arange(1, n_il + 1),
                        "xline": np.arange(1, n_xl + 1),
                        "twt": np.arange(ns) * 0.25e-3},
                data_vars=data_vars,
                attrs={"history": "synthetic;", "bin_size_iline": 10.0,
                       "bin_size_xline": 5.0},
                var_attrs={"amp": {"units": "a.u."}},
                coord_attrs={"twt": {"units": "s"}})


def _assert_tol(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


PRE_CASES = {
    "jax-test": dict(balance="rms", gain_args={"tpow": 1.0},
                     filter_type="lowpass", filter_freqs=[600.0, 900.0],
                     resample_to=32, envelope=True),
    "max-bandpass": dict(balance="max", filter_type="bandpass",
                         filter_freqs=[30.0, 80.0, 700.0, 1200.0]),
    "attrs-poly": dict(balance="rms", balance_store_ref=False,
                       resample_to=48, resample_method="poly",
                       attrs_config={"attrs_time": {
                           "cube": {"title": "streamed"},
                           "amp": {"long_name": "amplitude"},
                           "twt": {"long_name": "two-way time"}}}),
}


@pytest.mark.parametrize("case", sorted(PRE_CASES))
def test_streamed_preprocess_matches_in_memory_and_jax(tmp_path, case):
    kw = PRE_CASES[case]
    src = str(tmp_path / "in.nc")
    write_cube(src, _time_cube(extra=True))
    ram = pre.preprocess(read_cube(src), device=CPU, **kw)
    out = pre.preprocess(src, out_path=str(tmp_path / "ooc.nc"),
                         out_of_core=True, block=5, device=CPU, **kw)
    assert out == str(tmp_path / "ooc.nc")
    ooc = read_cube(out)
    jout = jpreprocess(src, out_path=str(tmp_path / "jax.nc"),
                       out_of_core=True, block=5, **kw)
    jooc = jread_cube(jout)
    assert set(ooc.data_vars) == set(jooc.data_vars)
    for k, (_, want) in ram.data_vars.items():
        if k in ooc.data_vars:  # the resampled 'quality' is dropped
            np.testing.assert_array_equal(ooc[k], want)
    for k in ooc.data_vars:
        assert ooc[k].dtype == np.asarray(jooc[k]).dtype, k
        if np.issubdtype(ooc[k].dtype, np.floating):
            _assert_tol(ooc[k], jooc[k])
        else:
            np.testing.assert_array_equal(ooc[k], jooc[k])
    np.testing.assert_array_equal(ooc.coords["twt"], jooc.coords["twt"])
    assert ooc.attrs["history"] == jooc.attrs["history"] == \
        ram.attrs["history"]
    assert ooc.attrs.get("title") == jooc.attrs.get("title")
    assert ooc.var_attrs["amp"] == jooc.var_attrs["amp"]
    assert ooc.coord_attrs["twt"] == jooc.coord_attrs["twt"]
    # the slab loop over an in-memory source and sink: the same cube
    store = MemoryStore()
    pre.preprocess_slabs(MemoryCube.from_cube(read_cube(src)), store, "amp",
                         block=3, device=CPU, **kw)
    mem = store.final.to_cube()
    for k in ooc.data_vars:
        np.testing.assert_array_equal(mem[k], ooc[k])


POST_CASES = {
    "jax-test": dict(upsample_factors="auto", footprint={"sigma": 3},
                     smoothing={"kind": "gaussian", "sigma": 1.0},
                     agc_win=0.004),
    "rescale-median": dict(smoothing={"kind": "median", "size": 3,
                                      "rescale_percentiles": [1.0, 99.0]}),
    "chain-2x2-rescale-agc": dict(
        upsample_factors={"iline": 2, "xline": 2}, footprint={},
        smoothing={"kind": "gaussian", "sigma": 1.0,
                   "rescale_percentiles": [2.0, 98.0]},
        agc_win=0.004, agc_sqrt=True),
    "antialias-only": dict(upsample_factors={"xline": 3}),
}


@pytest.mark.parametrize("case", sorted(POST_CASES))
def test_streamed_postprocess_matches_in_memory_and_jax(tmp_path, case):
    kw = dict(POST_CASES[case], var="amp")
    src = str(tmp_path / "in.nc")
    write_cube(src, _time_cube(n_il=12, n_xl=10, ns=48, extra=True))
    ram = post.postprocess(read_cube(src), device=CPU, **kw)
    out = post.postprocess(src, out_path=str(tmp_path / "ooc.nc"),
                           out_of_core=True, block=7, device=CPU, **kw)
    assert out == str(tmp_path / "ooc.nc")
    # the temporary files beside the output are gone
    assert sorted(os.listdir(tmp_path)) == ["in.nc", "ooc.nc"]
    ooc = read_cube(out)
    jout = jpost.postprocess(src, out_path=str(tmp_path / "jax.nc"),
                             out_of_core=True, block=7, **kw)
    jooc = jread_cube(jout)
    assert set(ooc.data_vars) == set(jooc.data_vars) == set(ram.data_vars)
    np.testing.assert_array_equal(ooc["amp"], ram["amp"])
    _assert_tol(ooc["amp"], jooc["amp"])
    for k in ooc.data_vars:
        if k != "amp":  # the riders, untouched
            np.testing.assert_array_equal(ooc[k], jooc[k])
    for k in ("iline", "xline", "twt"):
        np.testing.assert_array_equal(ooc.coords[k], jooc.coords[k])
    assert ooc.attrs["history"] == jooc.attrs["history"] == \
        ram.attrs["history"]
    for k in ("bin_size_iline", "bin_size_xline"):
        assert ooc.attrs[k] == jooc.attrs[k] == ram.attrs[k]
    assert ooc.var_attrs["amp"] == jooc.var_attrs["amp"]
    store = MemoryStore()
    post.postprocess_slabs(MemoryCube.from_cube(read_cube(src)), store,
                           block=5, device=CPU, **kw)
    mem = store.final.to_cube()
    np.testing.assert_array_equal(mem["amp"], ram["amp"])
    assert mem.attrs["history"] == ooc.attrs["history"]


def test_out_of_core_switches_on_the_threshold(tmp_path):
    src = str(tmp_path / "in.nc")
    write_cube(src, _time_cube())
    ram = post.postprocess(read_cube(src), upsample_factors={"xline": 2},
                           device=CPU)
    # the estimate: 12x10x64 float32 times the factor 2, 61,440 bytes
    for threshold, streams in ((61_439, True), (61_440, False)):
        out = post.postprocess(src, upsample_factors={"xline": 2},
                               out_path=str(tmp_path / "o.nc"),
                               ooc_threshold_bytes=threshold, device=CPU)
        assert isinstance(out, str) is streams
        np.testing.assert_array_equal(read_cube(tmp_path / "o.nc")["amp"],
                                      ram["amp"])
    out = pre.preprocess(src, balance="rms", out_path=str(tmp_path / "p.nc"),
                         ooc_threshold_bytes=10, device=CPU)
    assert out == str(tmp_path / "p.nc")
    with CubeFile(out) as f:
        assert f.dtype_of("amp") == np.float32
        assert f.dtype_of("fold") == np.int32


def _percentile_cases():
    rng = np.random.default_rng(0)
    ties = rng.normal(size=100_003).astype(np.float32)
    ties[::3] = 0.0
    # every value on a bin edge: [0, 65536] in 65536 bins of width 1
    edges = rng.integers(0, 65537, size=50_000).astype(np.float32)
    edges[:2] = (0.0, 65536.0)
    return {
        "ties": ties,
        "constant": np.full(10_001, 1.25, np.float32),
        "on-bin-edges": edges,
        "float64": rng.standard_cauchy(size=30_001),
        "one-value": np.float32([3.5]),
        "two-values": np.float32([2.0, -1.0]),
        "tiny-range": (1.0 + np.arange(5000) % 3
                       * np.finfo(np.float32).eps).astype(np.float32),
    }


QS = [0.0, 0.01, 1.0, 2.0, 33.3, 50.0, 98.0, 99.99, 100.0]


@pytest.mark.parametrize("case", sorted(_percentile_cases()))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_streamed_percentiles_are_numpys_exactly(case, as_tensor):
    data = _percentile_cases()[case]
    blocks = [data[i:i + 997] for i in range(0, data.size, 997)]
    blocks.insert(1, data[:0])  # an empty block anywhere in the stream
    if as_tensor:
        blocks = [torch.from_numpy(b.copy()) for b in blocks]
    got = post.streamed_percentiles(lambda: iter(blocks), QS)
    assert got == np.percentile(data, QS).tolist()
    # and the in-memory step's percentiles, from kthvalue
    assert post.percentiles(torch.from_numpy(data.copy()), QS) == \
        np.percentile(data, QS).tolist()


def test_streamed_percentiles_refine_a_crowded_bin(monkeypatch):
    """More than 4M values in one histogram bin: the bin is refined by
    further passes (``_order_stat``) before it is gathered."""
    rng = np.random.default_rng(1)
    data = np.concatenate([np.zeros(4_200_000, np.float32),
                           rng.normal(size=200_000).astype(np.float32),
                           np.float32([1e-30, -1e-30, 5e-31])])
    rng.shuffle(data)
    blocks = [data[i:i + 500_000] for i in range(0, data.size, 500_000)]
    calls = []
    real = post._order_stat

    def spy(*a, **k):
        calls.append(k.get("_depth", 0))
        return real(*a, **k)
    monkeypatch.setattr(post, "_order_stat", spy)
    qs = [1.0, 4.0, 50.0, 95.6, 99.0]
    got = post.streamed_percentiles(lambda: iter(blocks), qs)
    assert got == np.percentile(data, qs).tolist()
    assert calls  # the crowded bin was refined


def test_streamed_percentiles_refuse_an_empty_stream():
    with pytest.raises(ValueError, match="empty stream"):
        post.streamed_percentiles(lambda: iter([np.zeros(0, np.float32)]),
                                  [50.0])


# --- memory: child processes, peak resident set after imports ---------
_CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from pseudo_3d_interpolation_torch.io.ncio import read_cube
    from pseudo_3d_interpolation_torch.models.pocs import POCSConfig
    from pseudo_3d_interpolation_torch.pipeline.pocs import (
        interpolate_checkpointed)
    from pseudo_3d_interpolation_torch.pipeline.postprocess import (
        postprocess)

    def status(key):
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) * 1024

    step, mode, src, tmp = sys.argv[1:5]
    cfg = POCSConfig(niter=2, p_min=1e-3, version="fast")
    post_kw = dict(var="amp", upsample_factors={{"xline": 2}},
                   agc_win=0.01)

    def run(path, tag):
        if step == "pocs" and mode == "stream":
            interpolate_checkpointed(path, cfg, tmp + "/ck" + tag, batch=16,
                                     out_path=tmp + "/out" + tag + ".nc",
                                     device="cpu")
        elif step == "pocs":
            interpolate_checkpointed(read_cube(path), cfg, tmp + "/ck" + tag,
                                     batch=16, device="cpu")
        elif mode == "stream":
            postprocess(path, out_path=tmp + "/out" + tag + ".nc",
                        out_of_core=True, block=8, device="cpu", **post_kw)
        else:
            postprocess(read_cube(path), device="cpu", **post_kw)

    # warm up on a small cube of the same kind: imports, plans, pools
    run(sys.argv[5], "_warm")
    try:
        with open("/proc/self/clear_refs", "w") as fh:
            fh.write("5")  # the peak resident set starts again from here
    except OSError:
        pass
    base = status("VmRSS")
    run(src, "")
    print("GROWTH", status("VmHWM") - base)
""")


def _child(step, mode, src, tmp, warm):
    code = _CHILD.format(repo=str(REPO))
    r = subprocess.run([sys.executable, "-c", code, step, mode, src,
                        str(tmp), warm], capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-3000:]
    return int(r.stdout.split("GROWTH")[-1])


def _freq_file(path, il, xl, f, seed=0):
    rng = np.random.default_rng(seed)
    fold = (rng.uniform(size=(il, xl)) < 0.5).astype(np.int32)
    coords = {"iline": np.arange(il), "xline": np.arange(xl),
              "freq_twt": np.arange(f, dtype=np.float64)}
    with CubeWriter(path, coords, attrs={"history": "synthetic;"}) as w:
        w.create_var("freq_env", ("iline", "xline", "freq_twt"),
                     np.complex64, chunks={"freq_twt": 16})
        w.create_var("fold", ("iline", "xline"), np.int32)
        w.write_slab("fold", fold)
        for f0 in range(0, f, 64):
            n = min(64, f - f0)
            blk = (rng.normal(size=(il, xl, n))
                   + 1j * rng.normal(size=(il, xl, n))).astype(np.complex64)
            w.write_slab("freq_env", blk * fold[..., None], dim="freq_twt",
                         start=f0)
    return il * xl * f * 8


def _amp_file(path, il, xl, ns, seed=0):
    rng = np.random.default_rng(seed)
    coords = {"iline": np.arange(il), "xline": np.arange(xl),
              "twt": np.arange(ns) * 0.25e-3}
    with CubeWriter(path, coords, attrs={"history": "synthetic;"}) as w:
        w.create_var("amp", ("iline", "xline", "twt"), np.float32,
                     chunks={"iline": 16, "twt": 8})
        for i0 in range(0, il, 16):
            w.write_slab("amp", rng.normal(size=(min(16, il - i0), xl, ns))
                         .astype(np.float32), dim="iline", start=i0)
    return il * xl * ns * 4


@pytest.mark.parametrize("step", ["pocs", "postprocess"])
def test_streamed_child_grows_under_half_the_cube_where_in_ram_cannot(
        tmp_path, step):
    src, warm = str(tmp_path / "in.nc"), str(tmp_path / "warm.nc")
    if step == "pocs":
        nbytes = _freq_file(src, 128, 128, 1024)  # 134 MB
        _freq_file(warm, 16, 16, 40, seed=1)
    else:
        nbytes = _amp_file(src, 256, 128, 1024)  # 134 MB; 268 upsampled
        _amp_file(warm, 16, 16, 64, seed=1)
    stream = _child(step, "stream", src, tmp_path, warm)
    ram = _child(step, "ram", src, tmp_path, warm)
    assert stream < nbytes // 2, (stream, nbytes)
    assert ram >= nbytes, (ram, nbytes)
    out = read_cube(tmp_path / "out.nc")
    var = "freq_env_interp" if step == "pocs" else "amp"
    assert np.isfinite(out[var]).all() and np.abs(out[var]).max() > 0
