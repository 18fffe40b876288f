"""The seeded north-star cube, made on the device with PyTorch.

The model is the north-star runner's dense cube
(``examples/northstar_run_torch.py``'s ``synthetic_cube``): three dipping
Gaussian-windowed cosine reflectors, ``a * exp(-8 arg**2) * cos(2 pi arg)``
with ``arg = (t - onset - dip_il * il - dip_xl * xl) * f0``, summed in
float32 from float64 terms. The seed sets each reflector's onset and two
dips within ``jitter`` of the runner's values (:func:`geometry`, a
generator on the host, so the draw is the same on every device) and draws
the bin mask that keeps a ``keep`` fraction of the (iline, xline) bins (a
generator on the cube's device). With ``jitter`` 0 the cube is the
runner's formula.
"""

from __future__ import annotations

import torch

SEED_MOD = 2**63  # torch generators take seeds below 2**64


def geometry(config: dict, seed: int) -> list[tuple[float, ...]]:
    """Each reflector's (onset in s, amplitude, f0 in Hz, iline dip in s,
    xline dip in s) for ``seed``: the configuration's fractions of the
    trace length, each scaled by a factor of 1 - jitter, 1 or 1 + jitter.
    The seed deals the three factors out over the reflectors, a new
    order for the onsets, the iline dips and the xline dips each: every
    seed's problem holds the same set of values in another order."""
    t = config["shape"][2]
    dt, jitter = config["dt_s"], config["jitter"]
    n = len(config["reflectors"])
    g = torch.Generator().manual_seed(int(seed) % SEED_MOD)
    steps = [1.0 + jitter * (2.0 * k / (n - 1) - 1.0) if n > 1 else 1.0
             for k in range(n)]
    order = [torch.randperm(n, generator=g).tolist() for _ in range(3)]
    span = t * dt
    out = []
    for k, (frac, amp, f0) in enumerate(config["reflectors"]):
        f = [steps[order[i][k]] for i in range(3)]
        out.append((frac * span * f[0], float(amp), float(f0),
                    config["dips"][0] * span * f[1],
                    config["dips"][1] * span * f[2]))
    return out


def dense_cube(config: dict, seed: int, device, block: int = 64
               ) -> torch.Tensor:
    """The (h, w, t) float32 dense cube on ``device``, ``block`` ilines at a
    time in float64."""
    h, w, t = config["shape"]
    dt = config["dt_s"]
    refl = geometry(config, seed)
    cube = torch.empty((h, w, t), dtype=torch.float32, device=device)
    t_axis = torch.arange(t, dtype=torch.float64, device=device) * dt
    xl = torch.arange(w, dtype=torch.float64, device=device)[None, :, None] / w
    for r0 in range(0, h, block):
        rows = min(block, h - r0)
        il = (torch.arange(r0, r0 + rows, dtype=torch.float64,
                           device=device)[:, None, None] / h)
        acc = torch.zeros((rows, w, t), dtype=torch.float32, device=device)
        for onset, amp, f0, dip_il, dip_xl in refl:
            tt = onset + dip_il * il + dip_xl * xl
            arg = (t_axis[None, None, :] - tt) * f0
            acc += (amp * torch.exp(-(arg * arg) * 8)
                    * torch.cos(2 * torch.pi * arg)).to(torch.float32)
        cube[r0:r0 + rows] = acc
    return cube


def bin_mask(config: dict, seed: int, device) -> torch.Tensor:
    """The (h, w) float32 mask, 1 on the bins kept, drawn on ``device``."""
    h, w, _ = config["shape"]
    g = torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)
    u = torch.rand((h, w), generator=g, device=device)
    return (u < config["keep"]).to(torch.float32)
