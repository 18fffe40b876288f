"""H100 roofline accounting for the port's kernels and solves.

Counterpart of ``pseudo_3d_interpolation_tpu/utils/roofline.py``, which
counts the TPU's matrix-unit multiply-accumulates per basis. The port's
kernels run fp32 line FFTs on the CUDA cores and stream slices through
HBM, so this module counts, for each kernel call, the fp32 operations
(5·n·log2 n per complex line FFT of length n) and the HBM bytes it must
move (each input read once, each output written once, and the scratch
passes where the design needs them), and turns them into the least time
the card could take: the larger of the operations over the fp32 peak and
the bytes over the memory rate (:func:`bound`). It also gives the
operations of one POCS iteration of one slice per basis
(:func:`iteration_flops`) and converts a measured slice-iteration rate
into achieved TFLOP/s and a share of the peak (:func:`achieved_tflops`,
:func:`mfu_pct`).

``chip_smoke.py`` takes every ``bound_ms`` it prints from here, and
PERF.md's kernel table takes its "Bound" column from the same numbers.
Every count takes plain shapes, so nothing here needs a card or torch;
:func:`plan_support` reads a plan's row support with numpy.

reference: no counterpart — the reference has no performance model.
"""

from __future__ import annotations

import math

# H100 SXM data sheet at 700 W: fp32 on the CUDA cores (no tensor cores:
# the kernels' FFTs are fp32 FMAs), HBM3
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms of a call of ``flops`` fp32 operations moving
    ``nbytes`` HBM bytes, and what sets it ('operations' or 'bytes')."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def line_flops(n: int) -> float:
    """5·n·log2 n flops of one complex FFT of length n."""
    return 5.0 * n * math.log2(n)


def fft2_flops(h: int, w: int) -> float:
    """5·n·log2 n flops of one complex 2-D transform of n = h·w points."""
    return 5.0 * h * w * math.log2(h * w)


# --- the folded solves and the iteration (PERF.md rows 1, 1b, 1c, 2) -------

def solve_bytes(batch: int, h: int, w: int, niter: int) -> int:
    """The compulsory bytes of one folded solve: the observed pair in, the
    result pair out, the mask, the thresholds, the costs."""
    return batch * h * w * 16 + h * w * 4 + niter * batch * 4 + batch * 4


def solve_work(batch: int, h: int, w: int, niter: int,
               basis: str = "fft", taps: int = 8,
               level: int = 3) -> tuple[float, int]:
    """(flops, bytes) of one ``pocs_solve`` call: per slice-iteration a
    forward and an inverse 2-D FFT ('fft'); four real 2-D DCTs at
    2.5·n·log2 n ('dct'); the periodized cascade's filter passes
    ('wavelet', :func:`wavelet_iteration_flops`, whose per-level
    thresholds add 8 floats a slice-iteration)."""
    nbytes = solve_bytes(batch, h, w, niter)
    if basis == "fft":
        per = 2 * fft2_flops(h, w)
    elif basis == "dct":
        per = 4 * 2.5 * h * w * math.log2(h * w)
    elif basis == "wavelet":
        per = wavelet_iteration_flops(w, level, taps)
        nbytes += niter * batch * 8 * 4
    else:
        raise ValueError(f"no folded solve for basis {basis!r}")
    return per * niter * batch, nbytes


def iteration_work(batch: int, h: int, w: int) -> tuple[float, int]:
    """(flops, bytes) of one ``pocs_iteration`` call: a forward and an
    inverse 2-D FFT per slice; the x and observed pairs in, the result
    pair out, the mask, the thresholds."""
    return (2 * fft2_flops(h, w) * batch,
            batch * h * w * 24 + h * w * 4 + batch * 4)


def wavelet_iteration_flops(n: int, level: int = 3, taps: int = 8) -> float:
    """Flops of one folded WAVELET iteration on an (n, n) slice: 2·taps
    flops per output of a 1-D filter pass, two passes per level, forward
    and inverse, re and im (the JAX module's ``wavelet_iteration_rmacs``
    counts the TPU's matmul form instead)."""
    return sum(16 * taps * (n >> lv) ** 2 for lv in range(level))


# --- the subband kernels (rows 3, 3c, 3d) ----------------------------------

def subband_pass_work(batch: int, h: int, w: int, support_rows: int,
                      nbands: int, nchunks: int,
                      spatial: bool = False) -> dict:
    """(bytes, flops) of each pass of one subband call, counted on the
    rows the kernel transforms: S = ``support_rows`` over the L bands, C
    band chunks. (a) reads X and ψ and writes the scratch on the S rows,
    one W-line FFT each; (b) reads and writes the scratch's S rows, two
    H-line FFTs of every column of every band; (c) reads the scratch and
    ψ on the S rows, one W-line FFT each, and writes the accumulator C
    times, reading it C − 1 times (and with ``spatial`` one more inverse
    W-line FFT of every row); spatial only: the column passes read and
    write a plane pair with one H-line FFT per column, the row pass one
    W-line FFT per row, each twice."""
    b, s_rows = batch, support_rows
    lw, lh = line_flops(w), line_flops(h)
    work = {
        "rows_inverse_kernel": (b * s_rows * w * 20, b * s_rows * lw),
        "cols_shrink_kernel": (b * s_rows * w * 16, b * nbands * w * 2 * lh),
        "rows_forward_acc_kernel": (
            b * s_rows * w * 12 + (2 * nchunks - 1) * b * h * w * 8,
            b * s_rows * lw + spatial * b * h * lw)}
    if spatial:
        work["cols_fft_kernel"] = (2 * b * h * w * 16, 2 * b * w * lh)
        work["rows_fft_kernel"] = (b * h * w * 16, b * h * lw)
    return work


def subband_work(batch: int, h: int, w: int, support_rows: int,
                 nbands: int, nchunks: int,
                 spatial: bool = False) -> tuple[float, int]:
    """(flops, bytes) of one ``subband_update`` (``spatial``:
    ``subband_update_spatial``) call: the passes' operations on the rows
    the windows touch, and the bytes of the slices in and out, the windows
    and the thresholds."""
    flops = sum(f for _, f in subband_pass_work(
        batch, h, w, support_rows, nbands, nchunks, spatial).values())
    return flops, batch * h * w * 16 + nbands * h * w * 4 + batch * nbands * 4


def subband_dense_flops(batch: int, h: int, w: int, nbands: int,
                        spatial: bool = False) -> float:
    """The dense count of a subband call: 2·L full 2-D FFTs per slice
    (2·L + 2 spatial), ignoring the rows the kernels skip."""
    return (2 * nbands + 2 * int(spatial)) * fft2_flops(h, w) * batch


def subband_keys_work(batch: int, h: int, w: int, support_rows: int,
                      nbands: int, nchunks: int) -> tuple[float, int]:
    """(flops, bytes) of the percentile route's pass 1 over every chunk
    (``subband_keys``): pass (a), and the column pass's inverse half
    writing |c| of every pixel of every band as float32 keys. The c_l the
    kernel keeps for pass 2, and the keys' histogram, are its own traffic,
    not the function's: not counted."""
    a_bytes, a_flops = subband_pass_work(batch, h, w, support_rows, nbands,
                                         nchunks)["rows_inverse_kernel"]
    return (a_flops + batch * nbands * w * line_flops(h),
            a_bytes + batch * nbands * h * w * 4)


def subband_shrink_work(batch: int, h: int, w: int, support_rows: int,
                        nbands: int, nchunks: int) -> tuple[float, int]:
    """(flops, bytes) of the percentile route's pass 2 over every chunk
    (``subband_shrink``): the column and accumulating passes of row 3,
    c_l's forward half; reading a kept c_l is the kernel's own traffic."""
    work = subband_pass_work(batch, h, w, support_rows, nbands, nchunks)
    return (work["cols_shrink_kernel"][1]
            + work["rows_forward_acc_kernel"][1],
            work["cols_shrink_kernel"][0]
            + work["rows_forward_acc_kernel"][0])


# --- the box kernel (rows 4, 4b) -------------------------------------------

def box_pass_work(batch: int, lg: int, sr: int, sc: int, nh: int,
                  nw: int) -> dict:
    """(bytes, flops) of each pass of one ``box_group_update`` call on an
    sr × sc box of an nh × nw grid: (1) the box columns into field columns
    (one H-line FFT each, the scratch G written), (2) every field row both
    ways (two W-line FFTs, G read and written), (3) the field columns back
    to the box, band-summed."""
    field = batch * lg * sc * nh * 8  # the scratch G, bytes
    col_flops = batch * lg * sc * line_flops(nh)
    return {
        "box_cols_inverse_kernel": (batch * sr * sc * 8 + field, col_flops),
        "box_rows_kernel": (2 * field, 2 * batch * lg * nh * line_flops(nw)),
        "box_cols_forward_kernel": (field + batch * sr * sc * 8, col_flops)}


def box_work(batch: int, lg: int, sr: int, sc: int, nh: int,
             nw: int) -> tuple[float, int]:
    """(flops, bytes) of one ``box_group_update`` call: a pruned FFT (the
    field from the box's sc nonzero columns, then along every row) and the
    same back to the box, per slice and band; the box pair in and out, the
    windows, the thresholds and the partial-DFT rows (sr·nh + sc·nw
    complex values) as the bytes."""
    flops = 2 * batch * lg * (sc * line_flops(nh) + nh * line_flops(nw))
    nbytes = (batch * sr * sc * 16 + lg * sr * sc * 4 + batch * lg * 4
              + (sr * nh + sc * nw) * 8)
    return flops, nbytes


def pruned_line_flops(n: int, line: int) -> float:
    """Flops of one pruned line transform of the percentile route's box
    row pass (``csrc/subband.cu``): n/s′ s′-point line FFTs, one a class,
    and 6·n for the twiddles of the classes' inputs or outputs."""
    return (n // line) * line_flops(line) + 6.0 * n


def box_row_flops(n: int, line: int | None) -> float:
    """Flops of one field row's transform along W in the box row pass: a
    pruned line (``line`` = s′, ``kernels.subband.box_line_plan``) or, in
    the general form (None), a full n-point line FFT."""
    return line_flops(n) if line is None else pruned_line_flops(n, line)


def box_keys_work(batch: int, lg: int, sr: int, sc: int, nh: int,
                  nw: int, line: int | None = None) -> tuple[float, int]:
    """(flops, bytes) of ``box_keys``: pass (1) and the row pass's inverse
    half in the form it takes (``line``: s′ of the pruned form, None for
    the general form), the keys of every field pixel written."""
    col = batch * lg * sc * line_flops(nh)
    row = batch * lg * nh * box_row_flops(nw, line)
    return (col + row, batch * sr * sc * 8 + lg * sr * sc * 4
            + batch * lg * nh * nw * 4)


def box_shrink_work(batch: int, lg: int, sr: int, sc: int, nh: int,
                    nw: int, line: int | None = None) -> tuple[float, int]:
    """(flops, bytes) of ``box_shrink``: the row pass both ways in the
    form it takes (``line`` as :func:`box_keys_work` takes it) and pass
    (3)."""
    col = batch * lg * sc * line_flops(nh)
    row = batch * lg * nh * box_row_flops(nw, line)
    return (col + 2 * row, batch * sr * sc * 8 + lg * sr * sc * 4
            + batch * lg * 4 + batch * sr * sc * 8)


# --- the selection (row 9) -------------------------------------------------

def select_work(segments: int, n: int) -> tuple[float, int]:
    """(flops, bytes) of one ``band_percentile`` call: one read of the
    keys of ``segments`` segments of ``n`` keys and the (q, tau) pair per
    segment; no floating-point work to speak of."""
    return 0.0, segments * n * 4 + 2 * segments * 4


# --- plans and whole iterations --------------------------------------------

def plan_support(plan, h: int, w: int, batch: int) -> dict:
    """The kernel packing of a SHEARLET or CURVELET plan at a batch: the
    full-size bands' support rows, their count and band chunks, the box
    groups as (lg, sr, sc), and the s′ of each box group's pruned row pass
    in the percentile route (None: the general form)."""
    from ..ops.kernels.subband import band_chunks, box_line_plan, row_support
    from ..ops.shearlet import _plan_kernel_pack

    full, _, boxes = _plan_kernel_pack(plan, h, w)
    offsets = row_support(full.psi)[0]
    lines = [box_line_plan(g.idx_w, w) for _, _, g in boxes]
    return {"support_rows": int(offsets[-1]), "nbands": len(offsets) - 1,
            "nchunks": len(band_chunks(offsets, batch, h, w)) - 1,
            "boxes": [(lg, len(g.idx_h), len(g.idx_w)) for _, lg, g in boxes],
            "box_lines": [None if p is None else p[1] for p in lines]}


def plan_iteration_flops(plan, h: int, w: int, batch: int = 1) -> dict:
    """Operations and bytes of one directional POCS iteration of a batch
    on the kernel route (``ops.shearlet._pocs_subband_apply_kernels``):
    the top-level FFT and inverse, one ``subband_update`` over the
    full-size bands and one ``box_group_update`` per box group. The
    counterpart of the JAX module's ``plan_iteration_rmacs``."""
    sup = plan_support(plan, h, w, batch)
    sub_f, sub_b = subband_work(batch, h, w, sup["support_rows"],
                                sup["nbands"], sup["nchunks"])
    box_f = box_b = 0
    for lg, sr, sc in sup["boxes"]:
        f, b = box_work(batch, lg, sr, sc, h, w)
        box_f, box_b = box_f + f, box_b + b
    base = 2 * fft2_flops(h, w) * batch
    return {"full_bands": sup["nbands"], "box_groups": sup["boxes"],
            "flops": base + sub_f + box_f, "flops_base": base,
            "flops_full": sub_f, "flops_box": box_f,
            "bytes": 4 * batch * h * w * 8 + sub_b + box_b}


def iteration_flops(basis: str, h: int, w: int, plan=None,
                    level: int = 3, taps: int = 8) -> float:
    """Flops of one POCS iteration of one (h, w) slice on ``basis``'s
    kernel route: 'fft', 'dct', 'wavelet' (the folded solves), 'shearlet'
    and 'curvelet' (``plan``: the basis' plan, :func:`plan_iteration_flops`
    at a batch of 1)."""
    basis = basis.lower()
    if basis in ("fft", "dct", "wavelet"):
        return solve_work(1, h, w, 1, basis, taps, level)[0]
    if plan is None:
        raise ValueError(f"basis {basis!r} needs its plan")
    return plan_iteration_flops(plan, h, w)["flops"]


def achieved_tflops(rate_slice_iters_per_s: float, flops: float) -> float:
    """Measured slice-iteration rate -> achieved fp32 TFLOP/s, with
    ``flops`` per slice-iteration (:func:`iteration_flops`)."""
    return rate_slice_iters_per_s * flops / 1e12


def mfu_pct(rate_slice_iters_per_s: float, flops: float,
            peak_flops: float = FP32_FLOPS) -> float:
    """Utilization (%) of the fp32 peak at a measured slice-iteration
    rate."""
    return 100.0 * achieved_tflops(rate_slice_iters_per_s, flops) * 1e12 \
        / peak_flops
