"""Debug printing helpers.

(reference: -DDEBUG synchronized per-rank printing,
utils/preAlps_utils.c:758 preAlps_int_printSynchronized /
CPLM_MatCSRPrintSynchronizedCoords.) In JAX the analog is jax.debug.print
with the shard index prefixed — callbacks are serialized by the runtime, so
output is readable without an explicit rank barrier.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from prealps_tpu.config import DEBUG


def print_sharded(name: str, value, axis_name: str | None = None):
    """Print a (summary of a) value from every shard, tagged by shard index.
    No-op unless PREALPS_TPU_DEBUG=1 (mirrors the reference's -DDEBUG gate)."""
    if not DEBUG:
        return
    if axis_name is not None:
        idx = jax.lax.axis_index(axis_name)
    else:
        idx = jnp.int32(0)
    v = jnp.asarray(value)
    jax.debug.print(
        "[shard {i}] " + name + ": shape={s} |min|={mn:.3e} |max|={mx:.3e}",
        i=idx, s=v.shape, mn=jnp.min(jnp.abs(v)), mx=jnp.max(jnp.abs(v)),
    )
