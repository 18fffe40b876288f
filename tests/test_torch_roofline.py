"""The port's H100 roofline (``utils/roofline.py``): the bounds PERF.md's
kernel table gives (NVIDIA H100 SXM data sheet: 67 TFLOP/s fp32, 3.35
TB/s; the table's "Bound" column, in ms to four significant digits)
reproduced to 0.5% from the shapes of ``chip_smoke.py``'s phases 3 and
17a (32 slices of 512², 50 iterations, the SHEARLET and CURVELET plans'
kernel packing), and the per-basis iteration counts and rates."""

import math

import pytest

from pseudo_3d_interpolation_torch.models.transforms import get_transform
from pseudo_3d_interpolation_torch.ops import shearlet as sh
from pseudo_3d_interpolation_torch.utils import roofline as rl

B, N, NITER = 32, 512, 50


def _support(basis):
    return rl.plan_support(get_transform(basis)._plan(N, N), N, N, B)


def _ms(work):
    return rl.bound(*work)[0]


def _near(got, want, rel=5e-3):
    assert abs(got - want) <= rel * want, (got, want)


def test_ceilings_and_rule():
    assert (rl.FP32_FLOPS, rl.HBM_BYTES_PER_S) == (67e12, 3.35e12)
    assert rl.bound(67e9, 0) == (1.0, "operations")
    assert rl.bound(0, 3.35e9) == (1.0, "bytes")
    assert rl.fft2_flops(512, 512) == 5.0 * 512 * 512 * 18
    assert rl.line_flops(8) == 120.0


@pytest.mark.parametrize("basis,want", [("fft", 1.127), ("dct", 1.127),
                                        ("wavelet", 1.052)])
def test_solve_bounds(basis, want):
    """Rows 1, 1b, 1c: operations-bound."""
    bnd = rl.bound(*rl.solve_work(B, N, N, NITER, basis))
    _near(bnd[0], want)
    assert bnd[1] == "operations"


def test_iteration_bound():
    """Row 2: bytes-bound, 201 MB."""
    flops, nbytes = rl.iteration_work(B, N, N)
    _near(_ms((flops, nbytes)), 0.06041)
    assert rl.bound(flops, nbytes)[1] == "bytes"
    _near(nbytes, 201e6, 1e-2)


@pytest.mark.parametrize("basis,dense,spatial", [
    ("SHEARLET", 0.8354, 0.8579), ("CURVELET", 0.6809, None)])
def test_subband_bounds(basis, dense, spatial):
    """Rows 3 and 3c: the support rows of the plan's full-size bands."""
    s = _support(basis)
    args = (B, N, N, s["support_rows"], s["nbands"], s["nchunks"])
    _near(_ms(rl.subband_work(*args)), dense)
    if spatial is not None:
        _near(_ms(rl.subband_work(*args, spatial=True)), spatial)
    # the dense count ignores the skipped rows: larger
    assert rl.bound(rl.subband_dense_flops(B, N, N, s["nbands"]), 0)[0] \
        > _ms(rl.subband_work(*args))
    work = rl.subband_pass_work(*args)
    assert sum(f for _, f in work.values()) == rl.subband_work(*args)[0]


@pytest.mark.parametrize("basis,boxes", [
    ("SHEARLET", [(5, 16, 0.05810), (8, 40, 0.09719)]),
    ("CURVELET", [(9, 72, 0.1157)])])
def test_box_bounds(basis, boxes):
    """Row 4: each box group of the 512² plan."""
    s = _support(basis)
    assert [(lg, sr) for lg, sr, _ in s["boxes"]] == \
        [(lg, side) for lg, side, _ in boxes]
    for (lg, sr, sc), (_, _, want) in zip(s["boxes"], boxes):
        _near(_ms(rl.box_work(B, lg, sr, sc, N, N)), want)
        passes = rl.box_pass_work(B, lg, sr, sc, N, N)
        assert sum(f for _, f in passes.values()) == \
            rl.box_work(B, lg, sr, sc, N, N)[0]


def test_percentile_bounds():
    """Rows 3d and 4b (means over the box groups) and row 9: 32×34
    segments of 512² keys, one read of 1.14 GB."""
    s = _support("SHEARLET")
    args = (B, N, N, s["support_rows"], s["nbands"], s["nchunks"])
    _near(_ms(rl.subband_keys_work(*args)), 1.790)
    _near(_ms(rl.subband_shrink_work(*args)), 1.893)
    assert s["box_lines"] == [16, 64]  # both groups' row passes pruned
    keys = [_ms(rl.box_keys_work(B, lg, sr, sc, N, N, line))
            for (lg, sr, sc), line in zip(s["boxes"], s["box_lines"])]
    shrink = [_ms(rl.box_shrink_work(B, lg, sr, sc, N, N, line))
              for (lg, sr, sc), line in zip(s["boxes"], s["box_lines"])]
    _near(sum(keys) / len(keys), 0.06518)
    _near(sum(shrink) / len(shrink), 0.05453)
    # the general form's full W-lines (the split plan's narrow groups)
    general = [_ms(rl.box_shrink_work(B, lg, sr, sc, N, N))
               for lg, sr, sc in s["boxes"]]
    _near(sum(general) / len(general), 0.07544)
    _near(_ms(rl.select_work(B * 34, N * N)), 0.3406)


@pytest.mark.parametrize("basis,k,line,keys,shrink", [
    ("SHEARLET", 0, 16, (0.05010, "bytes"), (0.03343, "operations")),
    ("SHEARLET", 1, 64, (0.08027, "bytes"), (0.07564, "operations")),
    ("CURVELET", 0, 128, (0.09060, "bytes"), (0.09953, "operations"))])
def test_percentile_box_bounds_per_group(basis, k, line, keys, shrink):
    """Row 4b group by group: the keys' bytes set box_keys's bound; the
    pruned lines, n/s′ s′-point FFTs and 6·n twiddle flops a row each way,
    box_shrink's."""
    s = _support(basis)
    lg, sr, sc = s["boxes"][k]
    assert s["box_lines"][k] == line
    assert rl.pruned_line_flops(N, line) == \
        (N // line) * 5 * line * math.log2(line) + 6 * N
    for work, (want, by) in ((rl.box_keys_work, keys),
                             (rl.box_shrink_work, shrink)):
        got = rl.bound(*work(B, lg, sr, sc, N, N, line))
        _near(got[0], want)
        assert got[1] == by


def test_split_plan_boxes_are_counted_by_their_sides():
    """A split group is an sr × sc box: its column passes scale with sc,
    its row pass with the field."""
    plan = sh.shearlet_plan(N, N, split_threshold=200)
    s = rl.plan_support(plan, N, N, B)
    assert (2, 447, 126) in s["boxes"] and (2, 126, 447) in s["boxes"]
    tall = rl.box_pass_work(B, 2, 447, 126, N, N)
    wide = rl.box_pass_work(B, 2, 126, 447, N, N)
    assert tall["box_rows_kernel"][1] == wide["box_rows_kernel"][1]
    assert wide["box_cols_inverse_kernel"][1] == \
        tall["box_cols_inverse_kernel"][1] * 447 / 126


def test_iteration_flops_per_basis_and_rates():
    """The per-iteration count of each basis on one slice, and the rate
    conversions (the JAX module's ``achieved_tflops`` and ``mfu_pct``)."""
    fft = rl.iteration_flops("fft", N, N)
    assert fft == 2 * rl.fft2_flops(N, N)
    assert rl.iteration_flops("dct", N, N) == pytest.approx(fft)
    assert rl.iteration_flops("wavelet", N, N) == \
        rl.wavelet_iteration_flops(N)
    plan = get_transform("SHEARLET")._plan(N, N)
    it = rl.plan_iteration_flops(plan, N, N)
    assert rl.iteration_flops("shearlet", N, N, plan) == it["flops"]
    assert it["full_bands"] == 48 and len(it["box_groups"]) == 2
    assert it["flops"] == it["flops_base"] + it["flops_full"] \
        + it["flops_box"]
    with pytest.raises(ValueError, match="needs its plan"):
        rl.iteration_flops("curvelet", N, N)
    rate = 513 * 50 / 1.0  # slice-iterations per second of a 1 s cube
    assert rl.achieved_tflops(rate, fft) == pytest.approx(rate * fft / 1e12)
    assert rl.mfu_pct(rate, fft) == pytest.approx(
        100 * rate * fft / rl.FP32_FLOPS)
    assert math.isclose(rl.mfu_pct(67e12 / fft, fft), 100.0)
