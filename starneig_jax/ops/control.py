"""Control-flow helper: jitted dynamic while loops for iterative solvers.

Every iterative solver in this framework expresses its state machine as
(cond_fn, body_fn) over a state pytree.  :func:`make_bounded_while` builds a
runner for host-level call sites: one jitted ``lax.while_loop`` executed in
one dispatch, with no per-iteration host synchronization.

The reference achieves the same effect with its asynchronous segment list:
the StarNEig driver thread polls completed status handles between batches of
submitted work (``schur/core.c:2295-2336``); here the whole state machine
executes on-device and the host reads back only final states.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
from jax import lax


def make_bounded_while(cond_fn: Callable[[Any], Any],
                       body_fn: Callable[[Any], Any]):
    """Build a dynamic while-loop runner from (cond_fn, body_fn).

    Args:
      cond_fn: state -> bool scalar (pure; all parameters must live in the
        state pytree — no captured tracers).  Iteration caps live in the
        state machines themselves.
      body_fn: state -> state.

    Returns:
      run(state) -> final state.
    """
    @jax.jit
    def run(state):
        return lax.while_loop(cond_fn, body_fn, state)

    return run
