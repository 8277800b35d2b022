"""Faults planted underneath the timed path, for showing that the output
check fails a broken run: each ``fault(prog)`` breaks the port's step of a
:class:`harness.program.Program` in one way, and sets ``prog.restore``
where it patched the port itself. The faults a one-chip cell can have: a
step that returns its state unchanged; half of the batch left out; an
answer altered where it is produced (K1's result); and, under SCP, the
straggler phases left out. The exchange between chips does not exist on
one chip."""
from __future__ import annotations

from scp_tpu_torch.ops import ipm_kernel


def state_unchanged(prog):
    step = prog.step

    def broken(carry):
        nxt, out = step(carry)
        held = carry.state[:, None].expand_as(out.states)
        return nxt._replace(state=carry.state), out._replace(states=held)
    prog.step = broken


def half_batch_left_out(prog):
    step = prog.step

    def broken(carry):
        nxt, out = step(carry)
        h = out.u_pred.shape[0] // 2
        u_pred = out.u_pred.clone()
        u_pred[h:] = carry.u_prev1[h:, None, :]     # never solved: held
        return nxt, out._replace(u_pred=u_pred)
    prog.step = broken


def answer_altered(prog):
    """K1's primal result moved by 1% of the steering bound where the
    kernel returns it."""
    orig = ipm_kernel.ipm_iterate_struct
    u_lim = prog.cfg.u_lim

    def broken(*args, **kw):
        out = orig(*args, **kw)
        x = out[0].clone()
        x[:, 0] += 1e-2 * u_lim
        return (x,) + tuple(out[1:])
    prog.restore = lambda: setattr(ipm_kernel, "ipm_iterate_struct", orig)
    ipm_kernel.ipm_iterate_struct = broken


def phases_truncated(prog):
    """The SCP's straggler phases left out: every instance stops at the
    first phase's cap."""
    prog.phases = prog.phases[:1]


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch_left_out,
                                  answer_altered, phases_truncated)}
