"""KV-cached autoregressive decoding for the ternary transformer.

The serving loop behind the reference's small-M shapes: token-by-token
decode is exactly the M=1..32, K=N in {4096, 11008} SpMM regime the kernel
benchmarks target (``readme.md:84-85`` flop model).
This module runs that loop end-to-end:

* :func:`init_cache` — static-shape (B, H, max_T, hd) K/V cache per block
  (static shapes: XLA compiles ONE decode step; position is a traced
  scalar into ``dynamic_update_slice``, never a shape);
* decode steps for both backends — the QAT :class:`BitTransformerLM` and
  :class:`ExportedTransformerLM` (every projection a frozen ternary
  container running on the SpMM kernel registry);
* :func:`generate` — greedy decoding under ``lax.scan`` (one compile for the
  whole loop, no per-token retrace).

Incremental attention reproduces the full causal forward exactly: rotary at
the absolute position, logits against the cache, mask ``arange(max_T) <= pos``.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Type

import jax
import jax.numpy as jnp

from ternary_spgemm_tpu.formats.base import TernaryFormat
from ternary_spgemm_tpu.models.bitlinear import BitLinear  # noqa: F401 (doc)
from ternary_spgemm_tpu.models.exported import ExportedBitLinear
from ternary_spgemm_tpu.models.transformer import (
    BitTransformerBlock,
    BitTransformerConfig,
    BitTransformerLM,
    rms_norm,
)


def _rotary_at(x, pos, base: float = 10000.0):
    """Rotary embedding of ``x (B, H, 1, hd)`` at absolute position ``pos``
    (a traced scalar — same table row :func:`transformer.rotary_embed` uses
    statically at train time)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = base ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    ang = pos.astype(jnp.float32) * freqs
    cos, sin = jnp.cos(ang), jnp.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)


def init_cache(cfg: BitTransformerConfig, batch: int, max_t: int,
               dtype=jnp.float32, ring: bool = False):
    """Zeroed per-block K/V caches: a list of ``{"k","v"}: (B, H, max_T, hd)``.

    ``dtype=jnp.int8`` stores quantized K/V rows plus per-(token, head)
    absmax scales (``k_scale``/``v_scale`` (B, H, max_T, 1) f32) — 4×
    smaller cache; attention converts inside the dot reads and applies the
    scales outside (:func:`_cache_attn`), so the cache is never
    materialized at f32. The only approximation is the int8 rounding of
    cached rows (the W1.58-A8 regime's activation treatment applied to the
    cache). With GQA (``cfg.n_kv_heads``) H = the KV-head count — the
    cache shrinks by n_heads/n_kv_heads on top of the int8 4×.

    ``ring=True`` (requires ``cfg.window > 0``): a RING buffer of exactly
    ``window`` slots — position p lives at slot ``p % window``, each slot
    carries its absolute position in ``pos_tab (window,)`` (-1 = empty),
    and decode attention masks by stored position. The cache (and the
    per-step attention read) becomes O(window) regardless of generation
    length — the sliding-window memory win. Prompts longer than the
    window must prefill through a FULL cache first (prefill-then-attend
    ordering inside one chunk would evict keys its own earlier queries
    still need); :func:`generate` enforces this with a clear error."""
    hd = cfg.d_model // cfg.n_heads
    H = cfg.kv_heads
    slots = max_t
    extra = {}
    if ring:
        if not cfg.window:
            raise ValueError("ring=True requires cfg.window > 0")
        slots = cfg.window
        extra = {"pos_tab": jnp.full((slots,), -1, jnp.int32)}
    if jnp.dtype(dtype) == jnp.int8:
        z = jnp.zeros((batch, H, slots, hd), jnp.int8)
        s = jnp.zeros((batch, H, slots, 1), jnp.float32)
        return [{"k": z, "v": z, "k_scale": s, "v_scale": s, **extra}
                for _ in range(cfg.n_layers)]
    z = jnp.zeros((batch, H, slots, hd), jnp.float32)
    return [{"k": z, "v": z, **extra} for _ in range(cfg.n_layers)]


#: Precision of the float32 attention products over the KV cache. At XLA's
#: default a GPU runs them in TF32, whose rounding the per-row int8
#: requantize of the next projection turns into flipped int8 values. Measured
#: on an H100 (``tools/serve_probe.py``): one served layer of BitNet-3B is a
#: median 0.11 of a logit row off the float32 reference at the default and
#: 1.3e-3 at HIGHEST, and HIGHEST adds at most 2% to decode attention over
#: 4k- to 32k-token caches (a memory-bound batched matrix-vector product).
ATTENTION_PRECISION = jax.lax.Precision.HIGHEST


def _quant_rows(x):
    """Per-row (last-axis) absmax int8 quantization -> (int8, f32 scale)."""
    s = jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0 + 1e-12
    return jnp.round(x / s).astype(jnp.int8), s


def _cache_put(cache, k_new, v_new, pos):
    """Write (possibly quantizing) one-or-more rotated K/V rows at ``pos``.

    Ring caches (``pos_tab`` present) write at slot ``pos % window`` and
    record the absolute position. A multi-row write (prefill) into a ring
    must start the buffer (pos=0, T <= window) — no wrap; the generate()
    entry point enforces the prompt-length precondition."""
    ring = "pos_tab" in cache
    T_new = k_new.shape[2]
    if ring:
        W = cache["pos_tab"].shape[0]
        slot = pos % W
        pos_tab = jax.lax.dynamic_update_slice(
            cache["pos_tab"],
            pos + jnp.arange(T_new, dtype=jnp.int32), (slot,))
    else:
        slot = pos
    out = {}
    if "k_scale" in cache:
        kq, ks = _quant_rows(k_new)
        vq, vs = _quant_rows(v_new)
        out = {
            "k": jax.lax.dynamic_update_slice(cache["k"], kq, (0, 0, slot, 0)),
            "v": jax.lax.dynamic_update_slice(cache["v"], vq, (0, 0, slot, 0)),
            "k_scale": jax.lax.dynamic_update_slice(
                cache["k_scale"], ks, (0, 0, slot, 0)),
            "v_scale": jax.lax.dynamic_update_slice(
                cache["v_scale"], vs, (0, 0, slot, 0)),
        }
    else:
        out = {"k": jax.lax.dynamic_update_slice(cache["k"], k_new,
                                                 (0, 0, slot, 0)),
               "v": jax.lax.dynamic_update_slice(cache["v"], v_new,
                                                 (0, 0, slot, 0))}
    if ring:
        out["pos_tab"] = pos_tab
    return out


def _cache_attn(q, cache, T=None, hd_scale=1.0):
    """Attention logits and value-combine over a (possibly int8) cache;
    returns ``(logits (B,H,Q,Tc), combine(probs) -> out)``.

    int8 caches are NEVER dequantized into a materialized f32 copy: the
    ``astype`` feeds a single einsum (XLA fuses the convert into the dot's
    operand read — the cache's HBM traffic stays 1 byte/element + scales)
    and the per-row scales apply OUTSIDE the dots, which is the same math
    distributed: ``q·(c_k s_k) == (q·c_k) s_k`` per key row. Both prefill
    and stepwise decode use this one formulation, so they stay identical.
    """
    quant = "k_scale" in cache
    ck, cv = cache["k"], cache["v"]
    if T is not None:
        ck, cv = ck[:, :, :T], cv[:, :, :T]
    hi = ATTENTION_PRECISION
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, ck.astype(jnp.float32),
                        precision=hi) * hd_scale
    if quant:
        ks = cache["k_scale"][..., 0]
        vs = cache["v_scale"][..., 0]
        if T is not None:
            ks, vs = ks[:, :, :T], vs[:, :, :T]
        logits = logits * ks[:, :, None, :]

        def combine(probs):
            return jnp.einsum("bhqk,bhkd->bhqd", probs * vs[:, :, None, :],
                              cv.astype(jnp.float32), precision=hi)
    else:
        def combine(probs):
            return jnp.einsum("bhqk,bhkd->bhqd", probs, cv, precision=hi)
    return logits, combine


def _cached_attend(n_heads, q, k_new, v_new, cache, pos, window: int = 0):
    """One-token attention against the cache; returns (out (B,1,d), cache').

    ``n_heads`` int or ``(n_q, n_kv)`` (GQA). The grouped form folds the
    G = n_q/n_kv query heads of each KV head into ``_cache_attn``'s query
    axis — the cache is read ONCE per kv head for all its queries (and the
    batched dot gets G rows of work instead of one). ``window``: the
    sliding-window span (0 = full causal)."""
    from ternary_spgemm_tpu.models.transformer import _norm_heads
    nq, nkv = _norm_heads(n_heads)
    B, _, d = q.shape
    hd = d // nq
    G = nq // nkv
    q = q.reshape(B, 1, nq, hd).transpose(0, 2, 1, 3)
    kv = lambda z: z.reshape(B, 1, nkv, hd).transpose(0, 2, 1, 3)
    k_new, v_new = kv(k_new), kv(v_new)
    q, k_new = _rotary_at(q, pos), _rotary_at(k_new, pos)
    cache = _cache_put(cache, k_new, v_new, pos)
    qg = q.reshape(B, nkv, G, hd)            # query axis = the group
    logits, combine = _cache_attn(qg, cache, hd_scale=hd ** -0.5)
    if "pos_tab" in cache:
        # ring buffer: slots are unordered; mask by each slot's STORED
        # absolute position (keys carry their rotary, so slot order is
        # irrelevant to the softmax+combine)
        pt = cache["pos_tab"]
        W = pt.shape[0]
        mask = (pt >= 0) & (pt <= pos) & (pos - pt < W)
    else:
        kidx = jnp.arange(cache["k"].shape[2])
        mask = kidx <= pos
        if window:
            mask = mask & (pos - kidx < window)
    logits = jnp.where(mask[None, None, None, :], logits, -jnp.inf)
    out = combine(jax.nn.softmax(logits, axis=-1))   # (B, nkv, G, hd)
    return out.reshape(B, nq, 1, hd).transpose(0, 2, 1, 3).reshape(B, 1, d), \
        cache


def _block_decode(n_heads, lin, norm_attn, norm_ffn, x, cache, pos,
                  ffn=None, qkv=None, window: int = 0):
    """One block, one token. ``lin(name, z)`` is the backend's projection;
    ``ffn(h) -> h`` overrides the dense SwiGLU (MoE-FFN blocks route the
    single-token batch through their experts); ``qkv(h) -> (q, k, v)``
    overrides the three attention input projections (the merged-QKV
    container)."""
    h = rms_norm(x, norm_attn)
    q, k, v = (qkv(h) if qkv is not None
               else (lin("wq", h), lin("wk", h), lin("wv", h)))
    attn, cache = _cached_attend(n_heads, q, k, v, cache, pos,
                                 window=window)
    x = x + lin("wo", attn)
    h = rms_norm(x, norm_ffn)
    if ffn is not None:
        x = x + ffn(h)
    else:
        x = x + lin("w_down", jax.nn.silu(lin("w_gate", h)) * lin("w_up", h))
    return x, cache


def _prefill_attend(n_heads, q, k, v, cache, start=None, window: int = 0):
    """Full-prompt causal attention that also fills the cache: one
    (B,T0,d) forward instead of T0 sequential M=1 decode steps. Math identical to ``transformer.causal_attend``; the
    cache stores ROTATED keys (same convention as :func:`_cached_attend`).
    GQA folds each KV head's G query heads into the query axis (G·T rows
    per kv head); the causal mask broadcasts per group.

    ``start=None``: the whole prompt from position 0 (static masks, cache
    read sliced to T). ``start`` a traced scalar: CHUNKED prefill — this
    call covers positions ``start..start+T-1``; attention reads the FULL
    cache with the dynamic mask ``k_idx <= start + q_local`` (earlier
    chunks' keys visible, later slots masked), so one compiled program
    serves every equal-size chunk. Chunk results are bitwise-independent
    of the chunking (per-row softmax; tested)."""
    from ternary_spgemm_tpu.models.transformer import _norm_heads
    nq, nkv = _norm_heads(n_heads)
    B, T, d = q.shape
    hd = d // nq
    G = nq // nkv
    q = q.reshape(B, T, nq, hd).transpose(0, 2, 1, 3)
    kv = lambda z: z.reshape(B, T, nkv, hd).transpose(0, 2, 1, 3)
    k, v = kv(k), kv(v)
    from ternary_spgemm_tpu.models.transformer import rotary_embed
    chunked = start is not None
    if chunked and "pos_tab" in cache:
        raise NotImplementedError(
            "chunked prefill into a ring cache is unsupported (writing a "
            "chunk before attending would evict keys its own earlier "
            "queries still need); prefill a full cache, or keep the whole "
            "prompt within the window")
    off = start if chunked else 0
    q, k = rotary_embed(q, offset=off), rotary_embed(k, offset=off)
    # attention reads through the cache (int8 caches: scale-outside-dot,
    # same formulation as decode) so prefill ≡ stepwise decode exactly
    cache = _cache_put(cache, k, v, off if chunked else 0)
    qg = q.reshape(B, nkv, G * T, hd)
    logits, combine = _cache_attn(qg, cache,
                                  T=None if chunked else T,
                                  hd_scale=hd ** -0.5)
    K = logits.shape[-1]
    logits = logits.reshape(B, nkv, G, T, K)
    if chunked:
        # (q_local, k_idx): keys up to the query's absolute position
        qabs = start + jnp.arange(T)[:, None]
        kidx = jnp.arange(K)[None, :]
        mask = kidx <= qabs
        if window:
            mask = mask & (qabs - kidx < window)
    else:
        mask = jnp.tril(jnp.ones((T, T), bool))      # (q_pos, k_pos)
        if window:
            qi = jnp.arange(T)[:, None]
            mask = mask & (qi - jnp.arange(T)[None, :] < window)
    logits = jnp.where(mask[None, None, None], logits, -jnp.inf)
    probs = jax.nn.softmax(logits, axis=-1).reshape(B, nkv, G * T, K)
    out = combine(probs).reshape(B, nq, T, hd)
    return out.transpose(0, 2, 1, 3).reshape(B, T, d), cache


def _block_prefill(n_heads, lin, norm_attn, norm_ffn, x, cache,
                   ffn=None, qkv=None, start=None, window: int = 0):
    """One block over the whole prompt (or one chunk of it), filling its
    cache."""
    h = rms_norm(x, norm_attn)
    q, k, v = (qkv(h) if qkv is not None
               else (lin("wq", h), lin("wk", h), lin("wv", h)))
    attn, cache = _prefill_attend(n_heads, q, k, v, cache, start=start,
                                  window=window)
    x = x + lin("wo", attn)
    h = rms_norm(x, norm_ffn)
    if ffn is not None:
        x = x + ffn(h)
    else:
        x = x + lin("w_down", jax.nn.silu(lin("w_gate", h)) * lin("w_up", h))
    return x, cache


def lm_prefill(model: BitTransformerLM, params, tokens, caches, start=None):
    """QAT backend prompt prefill: ``tokens (B, T0) -> (logits (B, T0,
    vocab), caches')`` — equivalent to T0 decode steps, one forward.
    ``start``: chunked-prefill absolute offset (:func:`chunked_prefill`).

    MoE caveat: expert capacity is computed from the per-call token count
    (S=B·T0 here vs S=B per decode step), so the equivalence requires a
    ``moe_capacity_factor`` large enough that routing never binds in
    either regime (docs/serving.md)."""
    x = params["embed"][tokens]
    new_caches = []
    for block, p, cache in zip(model.blocks, params["blocks"], caches):
        lin = (lambda b_, p_: lambda n, z: b_._layers[n].apply(p_[n], z))(
            block, p)
        ffn = None
        if block.moe is not None:
            ffn = (lambda b_, p_: lambda h: b_.moe.apply(p_["moe"], h)[0])(
                block, p)
        x, cache = _block_prefill(model.cfg.head_tuple, lin, p["norm_attn"],
                                  p["norm_ffn"], x, cache, ffn=ffn,
                                  start=start, window=model.cfg.window)
        new_caches.append(cache)
    x = rms_norm(x, params["norm_out"])
    return jnp.einsum("btd,vd->btv", x, params["embed"]), new_caches


def lm_decode_step(model: BitTransformerLM, params, tokens, caches, pos):
    """QAT backend: ``tokens (B,) int32 -> (logits (B, vocab), caches')``."""
    x = params["embed"][tokens][:, None, :]
    new_caches = []
    for block, p, cache in zip(model.blocks, params["blocks"], caches):
        lin = (lambda b_, p_: lambda n, z: b_._layers[n].apply(p_[n], z))(
            block, p)
        ffn = None
        if block.moe is not None:
            ffn = (lambda b_, p_: lambda h: b_.moe.apply(p_["moe"], h)[0])(
                block, p)
        x, cache = _block_decode(model.cfg.head_tuple, lin, p["norm_attn"],
                                 p["norm_ffn"], x, cache, pos, ffn=ffn,
                                 window=model.cfg.window)
        new_caches.append(cache)
    x = rms_norm(x, params["norm_out"])
    return jnp.einsum("btd,vd->btv", x, params["embed"])[:, 0], new_caches


def _qkv_hook(block, rows: int, bt):
    """The merged-QKV override for an exported block in the cached
    prefill/decode loops, or None when the block has separate q/k/v
    projections. ``bt(z)`` gives the (B, T) to restore on the 3-D
    activations."""
    if block.qkv is None:
        return None

    def qkv(h, b_=block):
        B, T = bt(h)
        return tuple(z.reshape(B, T, -1)
                     for z in b_._qkv(h.reshape(rows, -1)))
    return qkv


class ExportedTransformerLM:
    """A trained BitTransformerLM frozen layer-by-layer into ternary
    containers (registered pytree — pass THROUGH jit as an argument so the
    containers stay literal-free, docs/perf.md). Supports the full
    forward and the KV-cached decode step; every projection runs on the
    SpMM kernel registry."""

    def __init__(self, cfg: BitTransformerConfig, blocks, embed, norm_out,
                 head_dtype=None):
        from ternary_spgemm_tpu.models.transformer import (
            ExportedTransformerBlock)
        self.cfg = cfg
        self.blocks = list(blocks)
        assert all(isinstance(b, ExportedTransformerBlock) for b in self.blocks)
        # head_dtype=bfloat16 stores the tied embedding at half width: the
        # logits head streams the ENTIRE (vocab, d) matrix per decode step,
        # a pure memory-bytes cost bf16 halves; the embedding lookup
        # (one row) upcasts to f32 on read. Standard serving quantization;
        # the blocks' math is unaffected.
        self.embed = jnp.asarray(embed, head_dtype or jnp.float32)
        self.norm_out = jnp.asarray(norm_out, jnp.float32)

    @classmethod
    def from_params(cls, model: BitTransformerLM, params: dict,
                    format_cls: Type[TernaryFormat], *,
                    kernel: Optional[str] = None,
                    fused_qkv: bool = False, with_transpose: bool = True,
                    a8: bool = False, head_dtype=None, auto: bool = False,
                    auto_rows: int = 1, cache_path: Optional[str] = None,
                    **fmt_kwargs):
        """``auto=True`` replaces the user-set ``fused_qkv`` with a
        MEASURED decision (:func:`autotune_serving_flags`): separate and
        merged q/k/v projections are timed on a decode-shaped probe of one
        block, with the same ``kernel``, and the winner applies to every
        block (all blocks share the shape). Composes with
        ``kernel="auto"`` (per-projection measured kernel winners,
        ``ops/autotune.py``) and shares its JSON ``cache_path``."""
        from ternary_spgemm_tpu.models.transformer import (
            ExportedTransformerBlock)
        if auto and not model.cfg.moe_experts:
            picks = autotune_serving_flags(
                model.cfg, params["blocks"][0], format_cls, rows=auto_rows,
                a8=a8, kernel=kernel, cache_path=cache_path, **fmt_kwargs)
            fused_qkv = picks["fused_qkv"]
        blocks = [ExportedTransformerBlock.from_params(
            model.cfg, p, format_cls, kernel=kernel,
            fused_qkv=fused_qkv, with_transpose=with_transpose, a8=a8,
            **fmt_kwargs)
            for p in params["blocks"]]
        return cls(model.cfg, blocks, params["embed"], params["norm_out"],
                   head_dtype=head_dtype)

    def _head(self, x):
        """Tied-embedding logits head; bf16-stored embeddings run one bf16
        product with f32 accumulation (halves the per-step head bytes)."""
        return jnp.einsum("btd,vd->btv", x.astype(self.embed.dtype),
                          self.embed, preferred_element_type=jnp.float32)

    def __call__(self, tokens):
        """Full causal forward: ``tokens (B, T) -> logits (B, T, vocab)``."""
        x = self.embed[tokens].astype(jnp.float32)
        for block in self.blocks:
            x = block(x)
        x = rms_norm(x, self.norm_out)
        return self._head(x)

    def prefill(self, tokens, caches, start=None):
        """Prompt prefill: ``tokens (B, T0) -> (logits, caches')``.

        ``start`` (traced scalar) runs this call as ONE CHUNK of a longer
        prompt at absolute positions ``start..start+T0-1`` (see
        :func:`chunked_prefill` for the loop)."""
        B, T = tokens.shape
        x = self.embed[tokens].astype(jnp.float32)
        new_caches = []
        for block, cache in zip(self.blocks, caches):
            lin = (lambda b_: lambda n, z: b_.linears[n](
                z.reshape(B * T, -1)).reshape(B, T, -1))(block)
            qkv = _qkv_hook(block, B * T, lambda z: (B, T))
            ffn = None
            if block.moe is not None:
                ffn = (lambda b_: lambda h: b_.moe(h))(block)
            x, cache = _block_prefill(self.cfg.head_tuple, lin,
                                      block.norm_attn, block.norm_ffn,
                                      x, cache, ffn=ffn, qkv=qkv,
                                      start=start, window=self.cfg.window)
            new_caches.append(cache)
        x = rms_norm(x, self.norm_out)
        return self._head(x), new_caches

    def decode_step(self, tokens, caches, pos):
        """``tokens (B,) -> (logits (B, vocab), caches')`` via the caches."""
        B = tokens.shape[0]
        x = self.embed[tokens][:, None, :].astype(jnp.float32)
        new_caches = []
        for block, cache in zip(self.blocks, caches):
            lin = (lambda b_: lambda n, z: b_.linears[n](
                z.reshape(B, -1))[:, None, :])(block)
            qkv = _qkv_hook(block, B, lambda z: (B, 1))
            ffn = None
            if block.moe is not None:
                ffn = (lambda b_: lambda h: b_.moe(h))(block)
            x, cache = _block_decode(self.cfg.head_tuple, lin,
                                     block.norm_attn, block.norm_ffn,
                                     x, cache, pos, ffn=ffn, qkv=qkv,
                                     window=self.cfg.window)
            new_caches.append(cache)
        x = rms_norm(x, self.norm_out)
        return self._head(x)[:, 0], new_caches


def _unflatten_lm(aux, children):
    obj = object.__new__(ExportedTransformerLM)
    obj.cfg = aux
    obj.blocks, obj.embed, obj.norm_out = list(children[0]), children[1], children[2]
    return obj


jax.tree_util.register_pytree_node(
    ExportedTransformerLM,
    lambda m: ((tuple(m.blocks), m.embed, m.norm_out), m.cfg),
    _unflatten_lm)


def autotune_serving_flags(cfg: BitTransformerConfig, block_params: dict,
                           format_cls, *, rows: int = 1, a8: bool = True,
                           kernel: Optional[str] = None,
                           cache_len: int = 256, min_seconds: float = 0.2,
                           repeats: int = 2,
                           cache_path: Optional[str] = None,
                           verbose: bool = False, builder=None,
                           **fmt_kwargs) -> dict:
    """MEASURE the serving fast-path flag for one block shape.

    Builds one :class:`ExportedTransformerBlock` with separate q/k/v
    projections and one with the merged QKV container, both on ``kernel``,
    and times each at the decode shape (batch ``rows``, one token, KV cache
    of ``cache_len``) with the calibrated device-loop slope; returns
    ``{"fused_qkv": bool}`` for the faster. Memoized per (backend, format,
    widths, heads, window, rows, a8, kernel) in the same in-process + JSON
    cache as ``ops/autotune.py`` — serving processes with a ``cache_path``
    skip the probe.
    """
    from ternary_spgemm_tpu import platform
    from ternary_spgemm_tpu.bench.timing import time_device_loop
    from ternary_spgemm_tpu.models.transformer import (
        ExportedTransformerBlock)
    from ternary_spgemm_tpu.ops.autotune import _CACHE, _LOCK, _write_disk

    key = (platform.backend(), "servingflags",
           getattr(format_cls, "__name__", "builder"),
           cfg.d_model, cfg.head_tuple, cfg.window, cfg.d_ff, rows, bool(a8),
           kernel)
    skey = "|".join(map(str, key))

    def _decode(name: str) -> dict:
        return {"fused_qkv": name == "qkv"}

    with _LOCK:
        if key in _CACHE:
            if cache_path:
                _write_disk(cache_path, skey, _CACHE[key])
            return _decode(_CACHE[key])
        if cache_path and os.path.exists(cache_path):
            try:
                disk = json.load(open(cache_path))
                if skey in disk:
                    _CACHE[key] = disk[skey]
                    return _decode(disk[skey])
            except Exception:
                pass

    B = max(1, rows)
    cache = init_cache(cfg, B, cache_len)[0]
    x1 = jnp.zeros((B, 1, cfg.d_model), jnp.float32)
    dummy = jnp.zeros((8,), jnp.float32)
    best_name, best_t = "none", float("inf")
    for qkv in (False, True):
        # builder(qkv) -> block: alternative construction path for callers
        # holding ready containers instead of a QAT param dict
        blk = (builder(qkv) if builder is not None else
               ExportedTransformerBlock.from_params(
                   cfg, block_params, format_cls, kernel=kernel,
                   fused_qkv=qkv, with_transpose=False, a8=a8,
                   **fmt_kwargs))

        def block_fn(dz, bk, xx, cc):
            xx = xx + jnp.minimum(dz[0], 0.0)
            lin = (lambda n, z:
                   bk.linears[n](z.reshape(B, -1))[:, None, :])
            y, _ = _block_decode(cfg.head_tuple, lin, bk.norm_attn,
                                 bk.norm_ffn, xx, cc,
                                 jnp.int32(cache_len - 1),
                                 qkv=_qkv_hook(bk, B, lambda z: (B, 1)),
                                 window=cfg.window)
            return y

        t = time_device_loop(block_fn, dummy, aux=(blk, x1, cache),
                             min_seconds=min_seconds, repeats=repeats)
        name = "qkv" if qkv else "none"
        if verbose:
            print(f"serving flags {name}: {t.seconds * 1e6:.1f} us "
                  f"(spread {t.seconds_spread:.1%})", flush=True)
        if t.seconds < best_t:
            best_name, best_t = name, t.seconds
    with _LOCK:
        _CACHE[key] = best_name
        if cache_path:
            _write_disk(cache_path, skey, best_name)
    return _decode(best_name)


def chunked_prefill(lm, tokens, caches, chunk: int, *, params=None):
    """Long-prompt prefill in fixed-size chunks at bounded memory.

    Full prefill materializes O(T²) attention logits per block — at
    T=8k+ that dominates HBM. This runs the prompt through
    ``prefill(..., start=chunk_start)`` one chunk at a time: each chunk
    attends causally to everything already cached, so the result is
    EXACTLY the unchunked prefill (per-row softmax; tested), memory is
    O(T·chunk), and one compiled program serves all full chunks (the
    chunk start is a traced scalar). A trailing remainder chunk traces
    once more. Returns ``(last_chunk_logits (B, Tc, vocab), caches)``.

    Works for both backends. Reference counterpart: none (net-new
    long-context serving capability).
    """
    if isinstance(lm, BitTransformerLM):
        fill = lambda tr, tok, c, s: lm_prefill(lm, tr, tok, c, start=s)
        tree = params
    else:
        fill = lambda tr, tok, c, s: tr.prefill(tok, c, start=s)
        tree = lm
    B, T0 = tokens.shape
    step = jax.jit(fill)
    logits = None
    for s in range(0, T0, chunk):
        tok = tokens[:, s:s + chunk]
        logits, caches = step(tree, tok, caches, jnp.int32(s))
    return logits, caches


def _make_sampler(temperature: float, top_k: int, top_p: float):
    """``(key, logits (B, V)) -> tokens (B,)`` — greedy when temperature
    is 0, else temperature softmax with optional top-k and/or nucleus
    (top-p) truncation. Pure/jittable; all branches are trace-time."""
    def sample(key, logits):
        if temperature <= 0.0:
            return jnp.argmax(logits, axis=-1)
        logits = logits / temperature
        if top_k:
            kth = jax.lax.top_k(logits, top_k)[0][:, -1:]
            logits = jnp.where(logits < kth, -jnp.inf, logits)
        if top_p and top_p < 1.0:
            # nucleus: keep the smallest prefix of descending-prob tokens
            # whose cumulative mass reaches top_p (the first is always kept)
            sorted_l = jnp.sort(logits, axis=-1)[:, ::-1]
            probs = jax.nn.softmax(sorted_l, axis=-1)
            cum = jnp.cumsum(probs, axis=-1)
            keep = cum - probs < top_p            # mass BEFORE this token
            cutoff = jnp.min(jnp.where(keep, sorted_l, jnp.inf), axis=-1,
                             keepdims=True)
            logits = jnp.where(logits < cutoff, -jnp.inf, logits)
        return jax.random.categorical(key, logits, axis=-1)
    return sample


def generate(lm, prompt, n_new: int, *, params=None,
             max_t: Optional[int] = None, prefill: bool = True,
             cache_dtype=jnp.float32, ring: bool = False,
             temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0, key=None,
             return_logits: bool = False):
    """Decode ``n_new`` tokens after ``prompt (B, T0) int32``.

    ``lm`` is a :class:`BitTransformerLM` (pass its ``params``) or an
    :class:`ExportedTransformerLM`. With ``prefill=True`` (default) the
    prompt runs as ONE batched forward that fills the caches (T0
    sequential M=1 steps become one M=B·T0 SpMM workload), then the new tokens decode under ``lax.scan`` (one compile,
    static cache shapes). ``prefill=False`` keeps the pure step-by-step
    path. Returns ``(B, T0 + n_new)`` tokens.

    Sampling: ``temperature=0`` (default) is greedy; ``temperature>0``
    samples the softmax at that temperature, optionally truncated to the
    ``top_k`` highest logits and/or the ``top_p`` nucleus. Pass ``key``
    (a ``jax.random`` key) for reproducible sampling; sampling runs
    INSIDE the compiled scan (a per-step ``fold_in``), costing nothing
    extra at the serving scale.

    ``ring=True`` (sliding-window models): an O(window) ring-buffer KV
    cache — constant memory AND constant per-step attention cost however
    long the generation runs. Requires ``cfg.window > 0`` and the prompt
    to fit one window (longer prompts: prefill a full cache instead).

    ``return_logits=True`` (prefill path only) also returns the logits the
    run computed: ``(tokens, prefill_logits (B, T0, V), step_logits (B,
    n_new, V))``, where step ``i`` fed the token at position ``T0 + i``.
    """
    if return_logits and not prefill:
        raise ValueError("return_logits=True needs prefill=True")
    sampler = _make_sampler(temperature, top_k, top_p)
    if temperature > 0.0 and key is None:
        key = jax.random.key(0)
    if key is None:
        key = jax.random.key(0)   # unused by greedy; keeps one trace shape
    # The model/params pytree flows through jit as an ARGUMENT (``tree``
    # below), never a closure capture: a captured ExportedTransformerLM's
    # containers inline as HLO literal constants in the scan body — 2.2 GB
    # of literals at BitNet-7B, shipped with every compile and
    # keying the compile cache on the weight values (docs/perf.md).
    if isinstance(lm, BitTransformerLM):
        cfg = lm.cfg
        make_step = lambda tr: (lambda t, c, p: lm_decode_step(lm, tr, t, c, p))
        make_fill = lambda tr: (lambda t, c: lm_prefill(lm, tr, t, c))
        tree = params
    else:
        cfg = lm.cfg
        make_step = lambda tr: tr.decode_step
        make_fill = lambda tr: tr.prefill
        tree = lm
    B, T0 = prompt.shape
    max_t = max_t or (T0 + n_new)
    if ring:
        if not cfg.window:
            raise ValueError("generate(ring=True) requires cfg.window > 0")
        if prefill and T0 > cfg.window:
            raise ValueError(
                f"generate(ring=True): prompt length {T0} exceeds the "
                f"window ({cfg.window}); use prefill=False (stepwise "
                "feeding evicts legitimately) or prefill a full cache "
                "(ring prefill would evict keys its own queries need)")
    caches = init_cache(cfg, B, max_t, dtype=cache_dtype, ring=ring)

    if prefill:
        @jax.jit
        def _run(tr, prompt, caches, key):
            logits_all, caches = make_fill(tr)(prompt, caches)
            first = sampler(jax.random.fold_in(key, T0 - 1),
                            logits_all[:, T0 - 1]).astype(prompt.dtype)

            def scan_fn(carry, t):
                caches, cur = carry
                logits, caches = make_step(tr)(cur, caches, t)
                nxt = sampler(jax.random.fold_in(key, t),
                              logits).astype(prompt.dtype)
                return (caches, nxt), ((cur, logits) if return_logits
                                       else cur)

            _, out = jax.lax.scan(scan_fn, (caches, first),
                                  jnp.arange(T0, T0 + n_new))
            if return_logits:
                return out[0], logits_all, out[1]
            return out

        out = _run(tree, prompt, caches, key)
        gen = out[0] if return_logits else out
        tokens = jnp.concatenate([prompt, gen.T.astype(prompt.dtype)], axis=1)
        if return_logits:
            return tokens, out[1], jnp.swapaxes(out[2], 0, 1)
        return tokens

    @jax.jit
    def _run_nofill(tr, prompt, caches, key):
        def scan_fn(carry, t):
            caches, cur = carry
            # feed the prompt token at position t while t < T0, else the
            # previously generated token; emit the sample for position t+1
            tok = jnp.where(t < T0, prompt[:, jnp.minimum(t, T0 - 1)], cur)
            logits, caches = make_step(tr)(tok, caches, t)
            nxt = sampler(jax.random.fold_in(key, t),
                          logits).astype(prompt.dtype)
            return (caches, nxt), nxt

        cur0 = jnp.zeros((B,), prompt.dtype)
        _, gen = jax.lax.scan(scan_fn, (caches, cur0),
                              jnp.arange(T0 + n_new - 1))
        return gen

    gen = _run_nofill(tree, prompt, caches, key)
    # gen[t] predicts position t+1; positions T0..T0+n_new-1 are gen[T0-1:]
    return jnp.concatenate([prompt, gen[T0 - 1:].T.astype(prompt.dtype)], axis=1)
