"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis.

Completes the parallelism matrix (SURVEY.md §2.3 has dp/tp in
``models/train.py`` + ``parallel/spgemm.py``; this adds pp): transformer
blocks are grouped into P stages laid along a mesh axis, activations flow
stage-to-stage through a ``ppermute`` chain, and microbatches keep every
stage busy after the P-1-step fill. Everything is one ``shard_map``-wrapped
``lax.scan`` — ONE compiled program, no per-microbatch dispatch, and the
stage-to-stage sends are ICI neighbor hops (the cheapest collective there
is). Autodiff works through the whole schedule (``ppermute``'s transpose is
the reverse ring), so the same function trains; the backward schedule is
GPipe-naive (activations stashed by scan), not 1F1B.

Generic core: :func:`pipeline_apply` runs ANY ``stage_fn`` over stacked
per-stage params. Transformer glue: :func:`pipeline_lm_apply` pipelines a
:class:`~ternary_spgemm_tpu.models.transformer.BitTransformerLM`'s blocks
(embedding/head replicated outside the pipe).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def pipeline_apply(stage_fn, stacked_params, x, mesh: Mesh, *,
                   axis: str = "pipe", n_micro: int):
    """Run ``P`` pipeline stages over microbatched ``x``.

    ``stacked_params``: pytree whose leaves carry a leading stage axis of
    size ``P = mesh.shape[axis]`` (build with :func:`stack_stages`).
    ``stage_fn(local_params, h) -> h`` applies one stage; ``h`` keeps the
    microbatch shape ``(B/n_micro, ...)`` through every stage.

    Microbatch ``m`` enters stage 0 at step ``m`` and leaves stage ``P-1``
    at step ``m + P - 1``; the scan runs ``n_micro + P - 1`` steps. ``x`` is
    passed replicated (only stage 0 reads it) — production-scale input
    pipelines would feed stage 0's hosts directly.
    """
    Pn = mesh.shape[axis]
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible into {n_micro} microbatches")
    mb = B // n_micro
    xm = x.reshape((n_micro, mb) + x.shape[1:])
    steps = n_micro + Pn - 1

    def device_program(params, xm):
        params = jax.tree_util.tree_map(lambda a: a[0], params)  # drop P=1 dim
        stage = jax.lax.axis_index(axis)
        perm = [(d, d + 1) for d in range(Pn - 1)]

        def body(h, i):
            m = jnp.clip(i, 0, n_micro - 1)
            feed = jax.lax.dynamic_index_in_dim(xm, m, 0, keepdims=False)
            inp = jnp.where(stage == 0, feed, h)
            # pin the carry dtype to the input's: a stage_fn that computes
            # at a different dtype (e.g. compute_dtype="bfloat16" blocks)
            # would otherwise fail scan's carry typecheck
            out = stage_fn(params, inp).astype(xm.dtype)
            h_next = jax.lax.ppermute(out, axis, perm) if perm else out
            return h_next, out

        # the carry varies over the pipe axis (each stage holds a different
        # activation); mark the zero initializer accordingly or scan's
        # varying-axes typecheck rejects the ppermute output as carry
        h0 = jnp.zeros_like(xm[0])
        h0 = jax.lax.pcast(h0, (axis,), to="varying")
        _, outs = jax.lax.scan(body, h0, jnp.arange(steps))
        return outs[None]  # (1, steps, mb, ...) -> global (P, steps, ...)

    pspec = jax.tree_util.tree_map(lambda _: P(axis), stacked_params)
    outs = jax.shard_map(
        device_program, mesh=mesh, in_specs=(pspec, P()),
        out_specs=P(axis))(stacked_params, xm)
    # last stage's emissions, steps P-1 .. P-1+n_micro-1, in microbatch order
    y = outs[-1, Pn - 1:Pn - 1 + n_micro]
    return y.reshape((B,) + y.shape[2:])


def stack_stages(per_stage_params):
    """Stack a list of per-stage pytrees (identical treedefs) into one pytree
    with a leading stage axis — the layout :func:`pipeline_apply` shards."""
    return jax.tree_util.tree_map(
        lambda *leaves: jnp.stack(leaves), *per_stage_params)


# ---------------------------------------------------------------------------
# Transformer glue
# ---------------------------------------------------------------------------


def lm_stage_params(model, params, n_stages: int):
    """Group a BitTransformerLM's blocks into ``n_stages`` equal stages and
    stack: leaves get shape ``(n_stages, blocks_per_stage, ...)``."""
    nb = model.cfg.n_layers
    if nb % n_stages:
        raise ValueError(f"{nb} blocks do not split into {n_stages} stages")
    L = nb // n_stages
    stages = [stack_stages(params["blocks"][s * L:(s + 1) * L])
              for s in range(n_stages)]
    return stack_stages(stages)


def _lm_stage_fn(cfg):
    """Stage = scan of ``blocks_per_stage`` BitTransformerBlocks (leaves
    carry the leading block axis)."""
    from ternary_spgemm_tpu.models.transformer import BitTransformerBlock

    block = BitTransformerBlock(cfg)

    def stage(stacked_blocks, h):
        # blocks compute (and return) at cfg.compute_dtype: cast the scan
        # carry up-front so its type is stable across iterations
        h = h.astype(jnp.dtype(cfg.compute_dtype))
        return jax.lax.scan(
            lambda h, p: (block.apply(p, h), None), h, stacked_blocks)[0]

    return stage


def pipeline_lm_apply(model, params, tokens, mesh: Mesh, *,
                      axis: str = "pipe", n_micro: int):
    """BitTransformerLM forward with its blocks pipeline-parallel over
    ``axis`` (embedding and tied head replicated outside the pipe).
    Matches ``model.apply(params, tokens)`` exactly — for MoE-FFN configs
    only while expert capacity never binds (each microbatch routes
    S=(B/n_micro)·T tokens vs the plain forward's S=B·T, so a binding
    capacity would drop different tokens; see docs/serving.md)."""
    from ternary_spgemm_tpu.models.transformer import rms_norm

    Pn = mesh.shape[axis]
    x = params["embed"][tokens]
    x = pipeline_apply(_lm_stage_fn(model.cfg),
                       lm_stage_params(model, params, Pn), x, mesh,
                       axis=axis, n_micro=n_micro)
    x = rms_norm(x, params["norm_out"])
    return jnp.einsum("btd,vd->btv", x, params["embed"])
