"""The output check that decides ``correct``: at a few steps of the timed
window drawn from the seed, the carry the step started from, its outputs
and, for a sample of instances drawn from the seed, what each layer of the
step produced are copied out; after the window the plain reference
(``reference/``) recomputes the step in float64. Under SCP the straggler
phases depend on every instance's convergence, so there the reference runs
the whole batch and decides the phases from its own results
(:func:`whole_batch`); elsewhere it runs the sampled instances. One number
a layer, and under SCP one for the instances that the reference ran past
the first phase (``strag``), each the third quartile of its per-instance
gaps (:func:`reduce`), against the limit its configuration states
(``configs/<name>.json``, ``limits``)."""
from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("pre", "qp", "ctrl", "plant", "strag")
# what each number compares (printed beside it)
WHAT = {
    "pre": "condensed QP from the carry: gap / the sample's scale, Q3",
    "qp": "first QP's controls (K1): gap / u_lim, Q3",
    "ctrl": "controller's clamped prediction: gap / u_lim, Q3",
    "plant": "plant's next state: gap / each component's scale, Q3",
    "strag": "SCP stragglers' clamped prediction: gap / u_lim, Q3",
}
# The condensed QP's pieces compared: the cost's Hessian blocks and linear
# term, the prediction blocks and the free response. The cost's constant
# (gamma0) moves no solution and is zero to rounding when a vehicle starts
# on its reference, so it is not compared on its own.
PRE_KEYS = ("phi0", "psi0", "b3", "const3")


def plan(seed: int, mix: dict, batch: int) -> dict:
    """Window step -> the instances sampled at it, drawn from the seed."""
    chk = mix["check"]
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0x5CE11])
    steps = sorted(rng.choice(chk["first_steps"], chk["steps"],
                              replace=False).tolist())
    return {s: np.sort(rng.choice(batch, min(chk["instances"], batch),
                                  replace=False)) for s in steps}


def whole_batch(config: dict) -> bool:
    """Whether the step's result for an instance depends on the rest of the
    batch: SCP phases after the first run on a sub-batch packed with the
    batch's unconverged instances."""
    return any(frac > 1 for _, frac, *_ in (config.get("phases") or [])[1:])


def take(tensors: dict, rows) -> dict:
    """The rows ``rows`` of each tensor (``None``: all of them)."""
    if rows is None:
        return tensors
    return {k: v.index_select(0, rows) if torch.is_tensor(v) else v
            for k, v in tensors.items()}


def reference(config: dict, tensors: dict, cap: dict, **kw) -> dict:
    """The plain reference's step at a sampled step ``cap`` (the carry the
    port's loop reached), over the whole batch or the sampled rows."""
    from reference import step as ref_step
    rows = None if whole_batch(config) else cap["rows"]
    return ref_step.run(config, take(tensors, rows), take(cap["carry"], rows),
                        **kw)


def _sampled(config: dict, cap: dict, out: dict) -> dict:
    """A reference-side step's outputs (over the rows :func:`reference`
    ran) at the sampled rows."""
    keys = PRE_KEYS + ("u_pred", "state_next")
    if not whole_batch(config):
        return {k: out[k] for k in keys + ("qp_x",)}
    rows, b = cap["rows"], out["u_pred"].shape[0]
    cand = torch.cat([rows + c * b for c in range(out["qp_x"].shape[0] // b)])
    return {**take({k: out[k] for k in keys}, rows),
            "qp_x": out["qp_x"].index_select(0, cand)}


def stragglers(config: dict, ref: dict, seed: int, step: int,
               n: int) -> torch.Tensor:
    """Up to ``n`` instances, drawn from the seed, that the reference ran
    past the first phase's cap at this step."""
    first = config["phases"][0][0]
    cand = torch.nonzero(ref["iters"] > first)[:, 0].cpu().numpy()
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0x57A6, step])
    pick = np.sort(rng.choice(cand, min(n, len(cand)), replace=False))
    return torch.as_tensor(pick, dtype=torch.int64,
                           device=ref["iters"].device)


def step_gaps(config: dict, mix: dict, cap: dict, ref: dict, seed: int,
              step: int, side: dict | None = None) -> dict:
    """Per-instance gaps at one sampled step between the reference
    (:func:`reference`) and the program (``cap``: what the window copied
    out), or a control's outputs ``side`` (over the reference's rows)."""
    ref_s = _sampled(config, cap, ref)
    if side is None:
        full = cap["out"]["u_pred"]
        rows = cap["rows"]
        mine = {"pre": cap["pre"], "qp_x": cap["qp_x"],
                "u_pred": full.index_select(0, rows),
                "state_next": cap["out"]["state_next"].index_select(0, rows)}
    else:
        full = side["u_pred"]
        mine = _sampled(config, cap, side)
        mine["pre"] = {k: mine.pop(k) for k in PRE_KEYS}
    g = gaps(config, mine, ref_s)
    if whole_batch(config):
        idx = stragglers(config, ref, seed, step,
                         mix["check"]["stragglers"])
        d = (full.index_select(0, idx).double()
             - ref["u_pred"].index_select(0, idx).double())
        g["strag"] = (d.abs().flatten(1).amax(1)
                      / config["settings"]["u_lim"]).cpu()
    return g


def _rowwise(p, r):
    """Per row: max |p - r| over every other axis; and the scale, max |r|
    over the whole sample (a row of zeros has no scale of its own)."""
    p, r = p.double(), r.double()
    d = (p - r).abs().flatten(1).amax(1)
    return d, torch.clamp(r.abs().max(), min=1e-30)


def gaps(config: dict, prog: dict, ref: dict) -> dict:
    """Per sampled instance, each layer's gap between the port's and the
    reference's (1-D float64 tensors on the host)."""
    u_lim = config["settings"]["u_lim"]
    n = prog["qp_x"].shape[1] - 1                  # the last entry is the slack
    pre = None
    for k in PRE_KEYS:
        d, s = _rowwise(prog["pre"][k], ref[k])
        if k == "psi0":
            # the linear term against the cost's slope at the steering
            # bound: it is zero when a vehicle drives on its reference
            s = torch.maximum(s, ref["phi0"].double().abs().max() * u_lim)
        g = d / s
        pre = g if pre is None else torch.maximum(pre, g)
    r = ref["qp_x"].shape[0] // prog["u_pred"].shape[0]
    dq, _ = _rowwise(prog["qp_x"][:, :n], ref["qp_x"][:, :n])
    qp_gap = dq.reshape(r, -1).amax(0) / u_lim    # worst candidate
    du, _ = _rowwise(prog["u_pred"], ref["u_pred"])
    v = prog["state_next"].shape[1]
    ds = (prog["state_next"].double() - ref["state_next"].double()).abs()
    ss = torch.clamp(ref["state_next"].double().abs().amax(dim=(0, 1)),
                     min=1e-30)               # each state component's scale
    plant = (ds / ss).reshape(-1, v * ds.shape[2]).amax(1)
    return {"pre": pre.cpu(), "qp": qp_gap.cpu(), "ctrl": (du / u_lim).cpu(),
            "plant": plant.cpu()}


def reduce(per_instance: dict) -> dict:
    """Each number is the third quartile of its per-instance gaps over the
    run's sampled instance-steps. float32 rounding takes a few instances
    far from the float64 path (an SCP stop one iteration apart, a
    candidate side flipped), so the worst instance swings from seed to
    seed; the third quartile is steady, and fails when a quarter or more
    of the instances are wrong. A number with no instance to compare (no
    straggler in the reference at the sampled steps) reads 0."""
    out = {}
    for k, v in per_instance.items():
        x = torch.cat([torch.as_tensor(t).double().flatten() for t in v]) \
            if isinstance(v, list) else torch.as_tensor(v).double().flatten()
        out[k] = float(torch.quantile(x, 0.75)) if x.numel() else 0.0
    return out


def limits(config: dict) -> dict:
    return dict(config.get("limits") or {})


def verdict(numbers: dict, lims: dict) -> bool:
    """Every number that the configuration limits present, finite and
    within its limit."""
    return bool(lims) and all(
        k in numbers and np.isfinite(numbers[k]) and numbers[k] <= lims[k]
        for k in lims)
