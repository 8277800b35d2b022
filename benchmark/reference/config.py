"""Frozen copy of ``config.py`` of the PyTorch port, for the benchmark's
plain reference (imports nothing of the port). The port's docstring:

Static configuration and tensor containers (counterpart of
``scp_tpu/config.py``).

* :class:`SCPConfig` — frozen dataclass of Python scalars: everything that
  determines tensor shapes or control flow.
* :class:`ScenarioData` / :class:`VehicleParams` — containers of tensors
  (initial states, reference polylines, obstacle tables, per-vehicle
  weights). Every function of the port takes them WITH a leading batch axis
  ``B``; builders that make one scenario return ``B = 1``.

The calibrated ``TUNED_F32_*`` values are pinned equal to
``scp_tpu.config``'s by ``tests/test_torch_config.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

# Model dimensions (fixed by the bicycle model).
NX = 6  # state:   [x, y, heading, v_rear, accel, steering]
NU = 1  # control: steering-angle reference
NY = 2  # output:  [x, y] position

@dataclasses.dataclass(frozen=True)
class SCPConfig:
    """Static solver/problem configuration (hashable Python scalars)."""

    # Problem shape
    n_veh: int = 1
    n_obst: int = 0
    hp: int = 10            # prediction horizon
    hu: int = 10            # control horizon
    n_ref_points: int = 2   # padded length of reference polylines

    # Timing (seconds); multiples of tick_length after quantization.
    tick_length: float = 0.01
    dt: float = 0.4
    t_end: float = 20.0
    delay_x: float = 0.0
    delay_u: float = 0.03

    # Limits
    lateral_accel_limit: float = 9.81 / 2
    mechanical_steering_limit: float = math.pi / 180 * 3
    du_lim: float = math.pi / 180 * 6      # steering-rate limit per MPC step
    u_lim: float = math.pi / 180 * 3       # box bound in the QP

    # Collision geometry
    dsafe_extra: float = 1.0

    # SCP loop
    max_scp_iter: int = 20
    delta_tol: float = 1e-3
    delta_tol_rel: float = 0.0   # relative merit stop (needed for float32)
    u_step_tol: float = 0.0      # scale-free iterate-step stop (radians)
    merit_patience: int = 0      # >0: stop after this many consecutive
    # iterations without improving the best merit by the delta threshold
    scp_keep_best: bool = False  # return the best-merit iterate
    slack_weight: float = 1e5    # exact-penalty weight
    slack_ub: float = 1e8
    constraint_tolerance: float = 2 * 2.1 * 1e-3

    # Penalty-score constants
    c_quad: float = 1e9
    c_linear: float = 0.0

    # Inner QP solver
    qp_max_iter: int = 30
    qp_tol: float = 1e-7
    qp_fixed_iters: int = 0   # >0: run exactly this many IPM iterations
    qp_correctors: int = 0    # Gondzio centrality correctors per iteration
    qp_warm_dual: bool = False  # warm-start IPM duals from the previous
    # SCP iteration's solve
    qp_cheap_k: bool = False
    qp_kkt: str = "dense"  # "dense" | "banded" | "auto" (see solvers/qp.py)

    # Integration substeps: RK4 steps per tick for the plant.
    rk4_substeps: int = 1

    # Reference-compat switches:
    # Q10 — the carried state sees only the latest command over the whole
    # step (the actuator delay never reaches it). False = piecewise-constant
    # control with the delay switch.
    plant_compat_q10: bool = True
    # Q5 — obstacle violations invisible to the SCP stop rule when n_veh == 1.
    compat_q5: bool = True

    # Noise: std of the white noise on dx, dy.
    noise_std: float = 0.0

    # Controller: "scp" or "side_selection" (solvers/miqp.py).
    controller: str = "scp"

    def __post_init__(self):
        # hu != hp is an explicit unsupported subset of the closed-loop
        # engine; the condensed-matrix ops take hp/hu directly and still
        # support the Hu < Hp truncation.
        if self.hu != self.hp:
            raise ValueError(
                f"SCPConfig requires hu == hp for the closed-loop engine "
                f"(got hp={self.hp}, hu={self.hu}); the condensed-matrix "
                f"ops support Hu < Hp truncation directly via "
                f"ops.condensed.prediction_matrices(hp=, hu=)")
    side_selection_rounds: int = 2
    side_selection_cand_iters: int = 0
    obst_as_qcqp: bool = True

    # ---- derived tick quantities ----
    @property
    def ticks_per_sim(self) -> int:
        return round(self.dt / self.tick_length + 1e-8)

    @property
    def n_sim(self) -> int:
        return round(self.t_end / self.dt + 1e-8)

    @property
    def ticks_total(self) -> int:
        return self.n_sim * self.ticks_per_sim

    @property
    def ticks_delay_x(self) -> int:
        return round(self.delay_x / self.tick_length + 1e-8)

    @property
    def ticks_delay_u(self) -> int:
        return round(self.delay_u / self.tick_length + 1e-8)

    @property
    def n_pairs(self) -> int:
        return self.n_veh * (self.n_veh - 1) // 2

    @property
    def n_constraints(self) -> int:
        """Avoidance rows in the linearized QP."""
        return self.hp * (self.n_pairs + self.n_veh * self.n_obst)

    @property
    def delay_comp_time(self) -> float:
        """Horizon of the delay-compensation rollout."""
        return self.delay_x + self.dt + self.delay_u

    def replace(self, **kw: Any) -> "SCPConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class VehicleParams:
    """Per-vehicle parameter tensors, shape (B, n_veh) each."""

    lf: torch.Tensor        # center -> front axle [m]
    lr: torch.Tensor        # center -> rear axle  [m]
    length: torch.Tensor    # bumper-to-bumper [m]
    width: torch.Tensor     # [m]
    q: torch.Tensor         # tracking weight
    q_final: torch.Tensor   # terminal tracking weight
    r: torch.Tensor         # steering-rate weight


@dataclasses.dataclass
class ScenarioData:
    """Scenario tensors with a leading batch axis B."""

    x0: torch.Tensor           # (B, n_veh, NX) initial states
    u0: torch.Tensor           # (B, n_veh) initial steering commands
    params: VehicleParams
    # Reference polylines, padded to n_ref_points with the last vertex
    # repeated.
    ref_points: torch.Tensor   # (B, n_veh, n_ref_points, 2)
    ref_valid: torch.Tensor    # (B, n_veh, n_ref_points) bool
    # Obstacle table rows: [x, y, heading, speed, length, width].
    obstacles: torch.Tensor    # (B, n_obst, 6)
    dsafe_veh: torch.Tensor    # (B, n_veh, n_veh)
    dsafe_obst: torch.Tensor   # (B, n_veh, n_obst)


def tree_map(fn, obj, *rest):
    """Apply ``fn`` to every tensor of a (nested) dataclass / NamedTuple /
    tuple container (and to the matching tensors of ``rest``, containers of
    the same structure), keeping ``None`` and non-tensor leaves as they
    are."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *rest)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{
            f.name: tree_map(fn, getattr(obj, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        items = [tree_map(fn, x, *(r[i] for r in rest))
                 for i, x in enumerate(obj)]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj
