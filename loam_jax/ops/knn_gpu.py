"""Fused brute-force kNN for NVIDIA GPUs (Pallas through Triton).

``neighbors.bruteforce._knn_xla`` writes a (tile, M) squared-distance matrix
to device memory and reads it back k times (one argmin-and-mask pass per
neighbor). This kernel never materializes it: one program owns a block of
queries, loops over the targets in blocks, and keeps a running top-k per
query in registers.

Per target block the program computes squared distances by direct
coordinate differences (exact in f32, unlike the ``|q|^2+|t|^2-2q.t`` form;
see ``bruteforce._tile_knn``), adds the target penalty (0 for valid slots,
+inf for masked or padded ones), and then extracts candidates with
min/argmin passes only while some query of the block still has one that
beats its current k-th best. Most blocks hold no such candidate, so most
blocks cost one distance tile and one row minimum.

Semantics equal ``_knn_xla``: ascending distances, first-index ties (argmin
takes the first minimum within a block; a candidate joins the running list
behind equal entries, which come from earlier blocks and so have lower
indices), masked targets never selected, fewer than k results when fewer
targets qualify, strict ``<`` radius filter. With a radius, the running list
starts at a bound slightly above ``max_dist**2``: a target at or beyond it
could only fill a slot the radius filter masks anyway. Indices of masked
slots are unspecified (``KnnResult`` documents them as arbitrary).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: Queries per program, targets per loop step, warps per program. Block
#: sizes are powers of two (Triton). Chosen by a sweep on an H100 80GB HBM3
#: (700 W) at the planar search of a 64x1024 scan (19,584 x 19,584, k=5,
#: radius 2 m): (16, 64, 1) took 1.49 ms, the first default (64, 128, 4)
#: 6.56 ms, and XLA's plain form 3.95 ms. Small query blocks win because
#: they put ~1,200 programs on the card's 132 SMs.
BLOCK_Q = 16
BLOCK_T = 64
NUM_WARPS = 1


def _knn_kernel(qx_ref, qy_ref, qz_ref, tx_ref, ty_ref, tz_ref, pen_ref,
                *out_refs, k: int, block_t: int, bound2: float):
    d_refs, i_refs = out_refs[:k], out_refs[k:]
    qx, qy, qz = qx_ref[...], qy_ref[...], qz_ref[...]
    bq = qx.shape[0]
    dtype = qx.dtype
    inf = jnp.asarray(jnp.inf, dtype)
    n_blocks = tx_ref.shape[0] // block_t
    col = lax.broadcasted_iota(jnp.int32, (bq, block_t), 1)

    def insert(bd, bi, cv, ci):
        # stable insertion into the ascending list: the newcomer goes behind
        # equal (earlier, lower-index) entries (strict <), and from there on
        # every entry shifts down one slot
        bd, bi = list(bd), list(bi)
        shift = jnp.zeros(cv.shape, bool)
        for j in range(k):
            shift = shift | (cv < bd[j])
            bd[j], cv = jnp.where(shift, cv, bd[j]), jnp.where(shift, bd[j], cv)
            bi[j], ci = jnp.where(shift, ci, bi[j]), jnp.where(shift, bi[j], ci)
        return tuple(bd), tuple(bi)

    def block(b, carry):
        start = b * block_t
        sl = pl.ds(start, block_t)
        dx = qx[:, None] - tx_ref[sl][None, :]
        dy = qy[:, None] - ty_ref[sl][None, :]
        dz = qz[:, None] - tz_ref[sl][None, :]
        d2 = dx * dx + dy * dy + dz * dz + pen_ref[sl][None, :]

        def more(c):
            _, m, bd, _, n = c
            # any() lowers to reduce_or, which Triton lowering lacks
            one, zero = jnp.int32(1), jnp.int32(0)
            return (n < k) & (jnp.max(jnp.where(m < bd[k - 1], one, zero)) > 0)

        def take_one(c):
            d2, m, bd, bi, n = c
            am = lax.argmin(d2, 1, jnp.int32)  # Triton lowers only i32
            bd, bi = insert(bd, bi, m, am + start)
            d2 = jnp.where(col == am[:, None], inf, d2)
            return d2, jnp.min(d2, axis=1), bd, bi, n + 1

        bd, bi = carry
        _, _, bd, bi, _ = lax.while_loop(
            more, take_one, (d2, jnp.min(d2, axis=1), bd, bi, jnp.int32(0))
        )
        return bd, bi

    bd0 = tuple(jnp.full((bq,), bound2, dtype) for _ in range(k))
    bi0 = tuple(jnp.full((bq,), -1, jnp.int32) for _ in range(k))
    bd, bi = lax.fori_loop(0, n_blocks, block, (bd0, bi0))
    for j in range(k):
        d_refs[j][...] = bd[j]
        i_refs[j][...] = bi[j]


def _entry_bound(max_dist: float, dtype) -> float:
    """Squared-distance bound for entering the running list. A slot passes
    the radius filter iff ``sqrt(d2) < max_dist`` in the working dtype;
    every such ``d2`` is below ``(max_dist * (1 + 4 eps))**2``."""
    if max_dist <= 0:
        return float("inf")
    r = float(np.asarray(max_dist, dtype))
    return (r * (1.0 + 4.0 * float(jnp.finfo(dtype).eps))) ** 2


@functools.partial(
    jax.jit,
    static_argnames=("k", "max_dist", "block_q", "block_t", "num_warps",
                     "interpret"),
)
def knn_triton(
    queries: jax.Array,
    targets: jax.Array,
    target_mask: jax.Array,
    k: int,
    max_dist: float = 0.0,
    block_q: int = BLOCK_Q,
    block_t: int = BLOCK_T,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
):
    """Exact kNN, same contract as ``neighbors.bruteforce.knn``.

    Returns ``(indices, distances, mask)``, each (Q, k). ``interpret=True``
    runs the kernel in the Pallas interpreter (CPU tests).
    """
    from ..neighbors.bruteforce import KnnResult

    Q, M = queries.shape[0], targets.shape[0]
    dtype = queries.dtype
    if M == 0 or k == 0 or Q == 0:
        return KnnResult(
            jnp.zeros((Q, k), jnp.int32),
            jnp.full((Q, k), jnp.inf, dtype),
            jnp.zeros((Q, k), bool),
        )
    qp = -(-Q // block_q) * block_q
    mp = -(-M // block_t) * block_t
    q = jnp.zeros((qp, 3), dtype).at[:Q].set(queries)
    t = jnp.zeros((mp, 3), dtype).at[:M].set(targets.astype(dtype))
    pen = jnp.full((mp,), jnp.inf, dtype).at[:M].set(
        jnp.where(target_mask, 0.0, jnp.inf).astype(dtype)
    )

    q_spec = pl.BlockSpec((block_q,), lambda i: (i,))
    t_spec = pl.BlockSpec((mp,), lambda i: (0,))
    # under a type-checked shard_map the outputs vary over every mesh axis
    # an input varies over (the sharded-target search of parallel.distributed)
    vma = jax.typeof(q).vma | jax.typeof(t).vma | jax.typeof(pen).vma
    outs = pl.pallas_call(
        functools.partial(
            _knn_kernel, k=k, block_t=block_t,
            bound2=_entry_bound(max_dist, dtype),
        ),
        grid=(qp // block_q,),
        in_specs=[q_spec] * 3 + [t_spec] * 4,
        out_specs=[q_spec] * (2 * k),
        out_shape=[jax.ShapeDtypeStruct((qp,), dtype, vma=vma)] * k
        + [jax.ShapeDtypeStruct((qp,), jnp.int32, vma=vma)] * k,
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="loam_knn",
    )(q[:, 0], q[:, 1], q[:, 2], t[:, 0], t[:, 1], t[:, 2], pen)
    d2 = jnp.stack(outs[:k], axis=-1)[:Q]
    idx = jnp.stack(outs[k:], axis=-1)[:Q]
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    valid = idx >= 0
    if max_dist > 0:
        valid = valid & (dist < max_dist)
    return KnnResult(
        jnp.where(valid, idx, 0),
        jnp.where(valid, dist, jnp.inf),
        valid,
    )
