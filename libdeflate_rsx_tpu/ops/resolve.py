"""Device LZ copy-resolution (pass 2) as a parallel XLA pass.

The decode-side analog of the reference's copy-kernel machinery
(reference src/decompress/x86.rs:2030-2190 — ~50 specialized per-offset
copy kernels — and src/decompress/mod.rs:1258-1317 pattern broadcast),
re-designed for a device: instead of serially materializing each back
reference, every output byte position computes its *source literal* by
pointer doubling, so the whole pass is data-parallel over positions and
streams and runs as a handful of vectorized scan/gather rounds.

Given the pass-1 token columns (ops/pallas/inflate_tokens.py), for one
stream of N output bytes:

1. token output extents -> exclusive scan gives each token's start;
2. a batched binary search over the (sorted) token starts finds
   `cov[p]` = covering token of output position p;
3. parent pointers: `par[p] = p - dist(cov[p])` inside a match (this is
   correct for overlapping copies too — the parent is strictly smaller,
   so chains terminate at literals), `par[p] = p` at literals (roots);
4. pointer doubling `par <- par[par]` reaches every root in
   ceil(log2(max chain depth)) rounds (a run of N identical bytes is
   depth N but resolves in log2 N rounds); a final gather through the
   literal bytes yields the output.

Every step is a full-width vector op: the only "irregular" primitives
are take_along_axis gathers, which XLA implements natively — there is
no per-byte serial loop anywhere, on any input. Memory traffic is ~(rounds+2) x 4 bytes per output byte; rounds
adapt to the actual chain depth via the while_loop convergence test.

The same function drives the sharded decoder: resolution is per-stream
local, so it vmaps/shard_maps over the batch axis with no collectives.
"""

from __future__ import annotations

import functools

import numpy as np

from .tokens import KIND_SHIFT

__all__ = ["resolve_tokens_device", "resolve_batch_jax"]


def resolve_batch_jax(tokens, out_cap: int):
    """tokens (B, T) int32 -> (bytes (B, out_cap) uint8, outlen (B,)
    int32, ok (B,) bool). Pure jnp; jit/vmap/shard_map friendly.

    `ok` is False when a stream's tokens write past out_cap or a match
    reaches before the start of its output. Positions past a stream's
    outlen hold unspecified bytes; callers slice to outlen.
    """
    import jax
    import jax.numpy as jnp

    tokens = tokens.astype(jnp.int32)
    B, T = tokens.shape
    N = out_cap
    kind = (tokens >> KIND_SHIFT) & 3
    is_lit = kind == 1
    is_match = kind == 2
    ext = jnp.where(is_match, (tokens & 0xFF) + 3,
                    is_lit.astype(jnp.int32))
    ends = jnp.cumsum(ext, axis=1)
    starts = ends - ext
    outlen = ends[:, -1]
    ok = outlen <= N

    # covering token per output position p = the LAST token whose start
    # is <= p (starts are a cumsum, hence sorted per row, and every
    # token after the covering one starts at or past its end). Computed
    # as a batched binary search unrolled to ceil(log2(T+1)) gather
    # rounds: a scatter at these shapes cost minutes of compile on the
    # accelerator this was first written for, so this pass uses no
    # scatter at all.
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (B, N))
    lo = jnp.zeros((B, N), jnp.int32)
    hi = jnp.full((B, N), T, jnp.int32)
    for _ in range(max(1, int(np.ceil(np.log2(T + 1))))):
        act = lo < hi
        mid = (lo + hi) >> 1
        v = jnp.take_along_axis(starts, jnp.clip(mid, 0, T - 1), axis=1)
        go_right = act & (v <= pos)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(act & ~go_right, mid, hi)
    cov = lo - 1                 # -1 when no token starts at/before p
    covc = jnp.clip(cov, 0, T - 1)

    tcov = jnp.take_along_axis(tokens, covc, axis=1)        # (B, N)
    covk = jnp.where(cov < 0, 0, (tcov >> KIND_SHIFT) & 3)
    dist = ((tcov >> 8) & 0x7FFF) + 1
    par = jnp.where(covk == 2, pos - dist, pos)
    ok &= ~jnp.any((par < 0) & (pos < outlen[:, None]), axis=1)
    par = jnp.clip(par, 0, N - 1)
    lit = jnp.where(covk == 1, tcov & 0xFF, 0)

    # pointer doubling to the root literal of every position's chain
    max_rounds = max(1, int(np.ceil(np.log2(max(N, 2)))) + 1)

    def cond(carry):
        k, par, changed = carry
        return changed & (k < max_rounds)

    def body(carry):
        k, par, _ = carry
        par2 = jnp.take_along_axis(par, par, axis=1)
        return k + 1, par2, jnp.any(par2 != par)

    _, par, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), par, jnp.bool_(True)))

    out = jnp.take_along_axis(lit, par, axis=1).astype(jnp.uint8)
    return out, jnp.minimum(outlen, N), ok


@functools.lru_cache(maxsize=8)
def _jit_resolve(out_cap: int):
    import jax

    return jax.jit(functools.partial(resolve_batch_jax, out_cap=out_cap))


def resolve_tokens_device(token_cols, out_cap: int):
    """Resolve a batch of pass-1 token columns on device.

    token_cols: (B, T) int32 (device or host array) — one stream per
    row, step-major tokens. Returns list[bytes | None] of length B.
    """
    import jax.numpy as jnp

    toks = jnp.asarray(token_cols, jnp.int32)
    out, outlen, ok = _jit_resolve(out_cap)(toks)
    out_h = np.asarray(out)
    len_h = np.asarray(outlen)
    ok_h = np.asarray(ok)
    return [out_h[i, :len_h[i]].tobytes() if ok_h[i] else None
            for i in range(out_h.shape[0])]
