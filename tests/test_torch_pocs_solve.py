"""The port's POCS solve (pseudo_3d_interpolation_torch/ops/kernels/
pocs_solve.py) held against the JAX package's fused Pallas solve
(ops/pallas/pocs_iter.py::pocs_solve_fused, basis='fft'), which runs here in
interpret mode on the CPU exactly as tests/test_pallas_kernel.py runs it.
The same seeded numpy inputs go to both. On the CPU the wrapper takes its
plain PyTorch version; the CUDA kernel itself is held against that plain
version in tests/test_torch_cuda.py."""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.ops.pallas.pocs_iter import pocs_solve_fused
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import _build
from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks

torch.set_num_threads(2)

# soft/garrote are continuous in the coefficients, so reordered arithmetic
# (JAX: dense or radix-split fp32 matmul DFTs; port: torch.fft) moves the
# result by rounding only: measured ~2e-6·max|ref| at these sizes, held
# at 10x that
EXACT_TOL = 2e-5
COST_RTOL = 1e-4
# hard thresholds flip coefficients that sit at the threshold when the
# arithmetic is reordered (ROADMAP "Hard thresholds are not bit-stable"),
# so they are compared by SNR against the dense truth
SNR_TOL_DB = 0.1
NITER = 6

PATHS = [pytest.param(256, 256, True, id="split-256"),
         pytest.param(128, 128, False, id="dense-128"),
         pytest.param(128, 256, False, id="rect-128x256")]


def _inputs(b, h, w, niter, seed=0):
    """Plane-wave truth (on-bin wavenumbers), a 50% column mask, and an
    exponential decay from the observed spectrum's maxima."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((b, h, w), np.complex64)
    for i in range(b):
        for _ in range(4):
            fy, fx = rng.integers(1, 12, size=2)
            truth[i] += rng.uniform(0.5, 2.0) * np.exp(
                2j * np.pi * (fy * yy / h + fx * xx / w)
                + 1j * rng.uniform(0, 6.28))
    mask = np.ascontiguousarray(np.broadcast_to(
        (rng.uniform(size=w) < 0.5)[None, :], (h, w)), np.float32)
    obs = (truth * mask).astype(np.complex64)
    amax = np.abs(np.fft.fft2(obs)).max(axis=(-2, -1))
    m = np.arange(niter, dtype=np.float64)[:, None] / max(niter - 1, 1)
    decay = (0.99 * amax[None] * np.exp(np.log(1e-3 / 0.99) * m))
    return truth, obs, mask, decay.astype(np.float32)


def _jax(obs, mask, decay, op, version, use_split):
    res, cost = pocs_solve_fused(
        JCplx(jnp.asarray(obs.real), jnp.asarray(obs.imag)), mask, decay,
        alpha=0.75, thresh_op=op, version=version, interpret=True,
        use_split=use_split)
    return np.asarray(res.re) + 1j * np.asarray(res.im), np.asarray(cost)


def _port(obs, mask, decay, op, version, fn=ks.pocs_solve):
    res, cost = fn(Cplx(torch.from_numpy(np.ascontiguousarray(obs.real)),
                        torch.from_numpy(np.ascontiguousarray(obs.imag))),
                   torch.from_numpy(mask), torch.from_numpy(decay),
                   0.75, op, version)
    return res.re.numpy() + 1j * res.im.numpy(), cost.numpy()


def _snr(ref, x):
    return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                         / np.sum(np.abs(ref - x) ** 2))


@pytest.mark.parametrize("op", ["soft", "garrote"])
@pytest.mark.parametrize("version", ["regular", "fast"])
@pytest.mark.parametrize("h,w,split", PATHS)
def test_plain_matches_jax_kernel(h, w, split, version, op):
    _, obs, mask, decay = _inputs(2, h, w, NITER)
    ref, ref_cost = _jax(obs, mask, decay, op, version, split)
    got, cost = _port(obs, mask, decay, op, version, ks.pocs_solve_plain)
    assert np.abs(got - ref).max() <= EXACT_TOL * np.abs(ref).max()
    np.testing.assert_allclose(cost, ref_cost, rtol=COST_RTOL)


@pytest.mark.parametrize("version", ["regular", "fast"])
@pytest.mark.parametrize("h,w,split", PATHS)
def test_plain_matches_jax_kernel_hard_by_snr(h, w, split, version):
    truth, obs, mask, decay = _inputs(2, h, w, NITER, seed=1)
    ref, _ = _jax(obs, mask, decay, "hard", version, split)
    got, _ = _port(obs, mask, decay, "hard", version, ks.pocs_solve_plain)
    assert _snr(truth, got) > _snr(truth, obs) + 1.0  # the solve did work
    assert abs(_snr(truth, got) - _snr(truth, ref)) < SNR_TOL_DB


def test_wrapper_takes_plain_on_cpu_without_counting():
    _, obs, mask, decay = _inputs(2, 128, 128, 3)
    before = ks.pocs_solve.launches_by_basis["fft"]
    got, cost = _port(obs, mask, decay, "garotte", "fast")
    ref, ref_cost = _port(obs, mask, decay, "garrote", "fast",
                          ks.pocs_solve_plain)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(cost, ref_cost)
    assert ks.pocs_solve.launches_by_basis["fft"] == before


def test_zero_iterations_return_the_observation():
    """niter = 0 returns the initial state of pocs_iter.py:767: the
    observation, with cost +inf."""
    _, obs, mask, decay = _inputs(2, 128, 128, 1)
    got, cost = _port(obs, mask, decay[:0], "hard", "fast")
    np.testing.assert_array_equal(got, obs)
    assert np.isinf(cost).all()


_Z = torch.zeros(2, 32, 32)


@pytest.mark.parametrize("change,error", [
    ({"thresh_op": "soft-percentile"}, ValueError),
    ({"version": "adaptive"}, ValueError),
    ({"precision": "fastest"}, ValueError),
    ({"mask": torch.ones(64, 64)}, ValueError),
    ({"decay": torch.ones(3, 5)}, ValueError),
    ({"decay": torch.ones(3, 2, dtype=torch.float64)}, TypeError),
    ({"obs": Cplx(_Z.transpose(1, 2), _Z)}, ValueError),  # non-contiguous
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, error):
    args = {"obs": Cplx(_Z, _Z), "mask": torch.ones(32, 32),
            "decay": torch.ones(3, 2), "thresh_op": "hard",
            "version": "fast", "precision": "high"}
    args.update(change)
    with pytest.raises(error):
        ks.pocs_solve(**args)


def _fake_nvcc(tmp_path, script: str):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return tmp_path / "cuda"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()


def test_build_raises_when_nvcc_fails(monkeypatch, tmp_path):
    home = _fake_nvcc(tmp_path, "echo 'error: bad kernel' >&2\nexit 2\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="bad kernel"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_targets_sm90a_and_reuses_an_unchanged_build(monkeypatch,
                                                          tmp_path):
    home = _fake_nvcc(tmp_path, (
        'echo "$@" >> "$(dirname "$0")/calls"\n'
        'while [ $# -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi; shift\n'
        'done\n'))
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.build()
    second = _build.build()
    srcs = _build.sources()
    assert first == second and set(first) == {s.stem for s in srcs}
    assert all(p.exists() for p in first.values())
    # one nvcc per source, each a library of its own
    calls = (home / "bin" / "calls").read_text().splitlines()
    assert len(calls) == len(srcs) >= 2
    for src in srcs:
        call = next(c for c in calls if c.endswith(src.name))
        assert "arch=compute_90a,code=sm_90a" in call and "-shared" in call
        assert os.path.exists(first[src.stem].with_suffix(".log"))
