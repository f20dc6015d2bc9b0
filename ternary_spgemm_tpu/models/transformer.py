"""BitNet-b1.58-style ternary transformer: QAT blocks + exported inference.

The reference targets "the BitNet-style ternary-LLM linear layer"
(SURVEY.md §0, §6; ``readme.md:84-85`` frames the flop model around LLM
serving shapes like K=N=4096/11008) but ships only the isolated SpMM. This
module supplies the model family those shapes come from, in the LLaMA
topology BitNet b1.58 keeps: RMSNorm → ternary QKV/O attention with rotary
embeddings → RMSNorm → ternary SwiGLU FFN, residuals around both.

Two regimes, matching :mod:`ternary_spgemm_tpu.models.bitlinear`:

* **QAT** (:class:`BitTransformerLM`): every linear is a latent-f32
  :class:`BitLinear` quantized through the straight-through estimator each
  forward pass — trainable end-to-end with ``jax.grad``/optax.
* **Exported inference** (:class:`ExportedTransformerBlock`): every linear is
  frozen into a registered ternary container and runs through the SpMM kernel
  registry (with the custom-VJP layers, so a frozen backbone still
  backpropagates to its inputs). Attention softmax/rotary stay XLA —
  elementwise chains fuse; the matrix work is the ternary projections.

All shapes are static and the causal mask is a compile-time constant, so
everything jits and shards under GSPMD. :func:`lm_param_shardings` gives
Megatron-style specs: QKV/gate/up split output features, O/down split input
features, so each block pays one psum per attention and one per FFN.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Type

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ternary_spgemm_tpu.formats.base import TernaryFormat
from ternary_spgemm_tpu.models.bitlinear import BitLinear
from ternary_spgemm_tpu.models.exported import ExportedBitLinear


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm (the BitNet/LLaMA norm; no mean subtraction, no bias).

    The variance accumulates in f32 regardless of compute dtype (bf16's 8
    mantissa bits lose the mean-of-squares); output returns to x's dtype.
    """
    xf = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps)).astype(x.dtype) * scale.astype(x.dtype)


def rotary_embed(x, *, base: float = 10000.0, offset=0):
    """Apply rotary position embeddings over the last axis of ``(..., T, D)``.

    Standard RoPE with the half-split pairing; positions are
    ``offset..offset+T-1``. With the default static offset 0 the table is a
    compile-time constant under jit (no dynamic gathers); a TRACED scalar
    offset keeps one compiled program reusable
    across chunk starts (chunked prefill)."""
    T, D = x.shape[-2], x.shape[-1]
    half = D // 2
    freqs = base ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    pos = jnp.arange(T, dtype=jnp.float32)
    if not (isinstance(offset, int) and offset == 0):
        pos = pos + jnp.asarray(offset, jnp.float32)
    ang = pos[:, None] * freqs[None, :]
    cos, sin = jnp.cos(ang).astype(x.dtype), jnp.sin(ang).astype(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)


def _norm_heads(n_heads):
    """``n_heads`` is an int (MHA) or ``(n_q_heads, n_kv_heads)`` (GQA —
    query head i attends kv head ``i // (n_q // n_kv)``)."""
    if isinstance(n_heads, int):
        return n_heads, n_heads
    nq, nkv = n_heads
    return int(nq), int(nkv)


def causal_attend(n_heads, q, k, v, window: int = 0):
    """(B, T, d) multi-head causal attention with rotary q/k; the mask is a
    compile-time constant (static T — no dynamic control flow under
    jit). ``n_heads`` may be ``(n_q, n_kv)`` for grouped-query attention
    (k/v arrive at width ``n_kv * head_dim``); the grouped einsum keeps the
    kv tensors un-repeated — each kv head serves its G query heads in one
    batched dot.
    ``window > 0``: sliding-window attention (each query sees the last
    ``window`` positions incl. itself — the Mistral local-attention
    pattern)."""
    B, T, d = q.shape
    nq, nkv = _norm_heads(n_heads)
    hd = d // nq
    G = nq // nkv
    q = q.reshape(B, T, nq, hd).transpose(0, 2, 1, 3)
    kv = lambda z: z.reshape(B, T, nkv, hd).transpose(0, 2, 1, 3)
    k, v = kv(k), kv(v)
    q, k = rotary_embed(q), rotary_embed(k)
    q5 = q.reshape(B, nkv, G, T, hd)
    logits = jnp.einsum("bngqd,bnkd->bngqk", q5, k,
                        preferred_element_type=jnp.float32) / (hd ** 0.5)
    mask = jnp.tril(jnp.ones((T, T), bool))
    if window:
        qi = jnp.arange(T)[:, None]
        mask = mask & (qi - jnp.arange(T)[None, :] < window)
    logits = jnp.where(mask, logits, -jnp.inf)
    probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)  # softmax in f32
    out = jnp.einsum("bngqk,bnkd->bngqd", probs, v).reshape(B, nq, T, hd)
    return out.transpose(0, 2, 1, 3).reshape(B, T, d)


@dataclasses.dataclass(frozen=True)
class BitTransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    #: grouped-query attention: number of shared K/V heads (0 = n_heads,
    #: plain MHA). Shrinks the KV cache and the decode-attention bytes by
    #: n_heads/n_kv_heads — the dominant serving memory lever at batch;
    #: wk/wv project to n_kv_heads*head_dim.
    n_kv_heads: int = 0
    #: sliding-window attention span (0 = full causal): each position sees
    #: the last ``window`` positions incl. itself (Mistral local pattern).
    #: Masking-level support — the KV cache keeps max_t slots; bounding the
    #: cache itself (ring buffer) composes with chunked prefill separately.
    window: int = 0
    d_ff: int = 384
    n_layers: int = 2
    # MoE FFN (expert parallelism): 0 = dense SwiGLU FFN, >0 = that many
    # ternary experts per block routed top-``moe_top_k`` (models/moe.py)
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 2.0
    # rematerialize each block's activations in the backward pass
    # (jax.checkpoint): activation memory O(L) -> O(1) blocks at the cost
    # of one extra forward — the HBM-capacity lever for deep stacks
    remat: bool = False
    # compute dtype for block internals (params/logits stay f32): bf16
    # halves activation memory traffic and doubles the tensor-core rate; the ternary
    # quantization braces values to gamma*{-1,0,1} so bf16's 8 mantissa
    # bits cover the QAT regime. Applies to the TRAINING forward
    # (apply/apply_with_aux); the KV-cached decode path (models/generate)
    # always serves at f32 master numerics by design.
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide into n_heads")
        if (self.d_model // self.n_heads) % 2:
            raise ValueError("head_dim must be even (rotary half-split)")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must divide into n_kv_heads (GQA "
                             "groups are equal-size)")

    @property
    def kv_heads(self) -> int:
        """Effective number of K/V heads (n_heads when MHA)."""
        return self.n_kv_heads or self.n_heads

    @property
    def head_tuple(self):
        """(n_q_heads, n_kv_heads) — the form the attention fns take."""
        return (self.n_heads, self.kv_heads)

    @property
    def kv_width(self) -> int:
        """wk/wv output width = n_kv_heads * head_dim."""
        return self.kv_heads * (self.d_model // self.n_heads)


class BitTransformerBlock:
    """One pre-norm block: ternary attention + ternary SwiGLU FFN.

    Linear layout (all :class:`BitLinear`, biasless ternary projections with
    the absmean scale): ``wq/wk/wv`` (d→d), ``wo`` (d→d), ``w_gate/w_up``
    (d→ff), ``w_down`` (ff→d). Params also carry the two RMSNorm scales.
    """

    LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    ATTN_LINEARS = ("wq", "wk", "wv", "wo")

    def __init__(self, cfg: BitTransformerConfig):
        self.cfg = cfg
        d, ff, kvw = cfg.d_model, cfg.d_ff, cfg.kv_width
        self._layers = {
            "wq": BitLinear(d, d), "wk": BitLinear(d, kvw),
            "wv": BitLinear(d, kvw), "wo": BitLinear(d, d),
        }
        if cfg.moe_experts:
            from ternary_spgemm_tpu.models.moe import BitMoE, BitMoEConfig
            self.moe = BitMoE(BitMoEConfig(
                d, ff, cfg.moe_experts, top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor))
            self.linear_names = self.ATTN_LINEARS
        else:
            self.moe = None
            self._layers.update({
                "w_gate": BitLinear(d, ff), "w_up": BitLinear(d, ff),
                "w_down": BitLinear(ff, d),
            })
            self.linear_names = self.LINEARS

    def init(self, key) -> dict:
        km, key = jax.random.split(key)
        keys = jax.random.split(key, len(self.linear_names))
        params = {n: self._layers[n].init(k)
                  for n, k in zip(self.linear_names, keys)}
        if self.moe is not None:
            params["moe"] = self.moe.init(km)
        params["norm_attn"] = jnp.ones((self.cfg.d_model,), jnp.float32)
        params["norm_ffn"] = jnp.ones((self.cfg.d_model,), jnp.float32)
        return params

    def apply(self, params: dict, x):
        return self.apply_with_aux(params, x)[0]

    def apply_with_aux(self, params: dict, x):
        """Block forward returning ``(x, aux)`` — aux is the MoE
        load-balancing loss (0.0 for dense-FFN blocks).

        Under a non-f32 ``compute_dtype`` the activations ride at the
        compute dtype and each layer casts its QUANTIZED weights down at
        use (BitLinear/BitMoE): ternarization decisions (round(W/gamma))
        stay f32-exact — casting the latent weights first flips weights
        near the 0.5 boundary, a discrete error far larger than bf16
        rounding. rms_norm and softmax keep f32 accumulations internally.
        """
        cdtype = jnp.dtype(self.cfg.compute_dtype)
        if x.dtype != cdtype:
            x = x.astype(cdtype)
        lin = lambda n, z: self._layers[n].apply(params[n], z)
        attend = lambda q, k, v: causal_attend(self.cfg.head_tuple, q, k, v,
                                               window=self.cfg.window)
        h = rms_norm(x, params["norm_attn"])
        attn = lin("wo", attend(lin("wq", h), lin("wk", h), lin("wv", h)))
        x = x + attn
        h = rms_norm(x, params["norm_ffn"])
        if self.moe is not None:
            ffn, aux = self.moe.apply(params["moe"], h)
        else:
            ffn = lin("w_down", jax.nn.silu(lin("w_gate", h)) * lin("w_up", h))
            aux = jnp.float32(0.0)
        return x + ffn, aux


class BitTransformerLM:
    """Ternary-backbone causal LM: f32 embeddings (BitNet keeps embeddings
    and head full-precision), ternary blocks, tied output head."""

    def __init__(self, cfg: BitTransformerConfig):
        self.cfg = cfg
        self.blocks = [BitTransformerBlock(cfg) for _ in range(cfg.n_layers)]

    def init(self, key) -> dict:
        ke, *kb = jax.random.split(key, self.cfg.n_layers + 1)
        return {
            "embed": jax.random.normal(
                ke, (self.cfg.vocab, self.cfg.d_model), jnp.float32)
            * self.cfg.d_model ** -0.5,
            "blocks": [b.init(k) for b, k in zip(self.blocks, kb)],
            "norm_out": jnp.ones((self.cfg.d_model,), jnp.float32),
        }

    def apply(self, params: dict, tokens, *, constrain=None):
        """``tokens (B, T) int32 -> logits (B, T, vocab)``."""
        return self.apply_with_aux(params, tokens, constrain=constrain)[0]

    def apply_with_aux(self, params: dict, tokens, *, constrain=None):
        """Forward returning ``(logits, aux)`` — aux is the mean MoE
        load-balancing loss across blocks (0.0 for dense-FFN models).

        ``constrain``: optional ``x -> x`` hook applied to the ``(B, T, d)``
        activations after the embedding and after every block. Passing a
        ``with_sharding_constraint`` to ``P(data, model, None)`` turns this
        into Megatron-style **sequence parallelism**: norms and residuals
        compute T-sharded over the TP axis, GSPMD all-gathers T right before
        the QKV/gate dots and turns the row-parallel psums into
        reduce-scatters (see :func:`models.train.make_sharded_lm_train_step`).
        """
        con = constrain or (lambda z: z)
        x = con(params["embed"][tokens])
        cdtype = jnp.dtype(self.cfg.compute_dtype)
        x = x.astype(cdtype)
        aux = jnp.float32(0.0)
        for block, p in zip(self.blocks, params["blocks"]):
            fn = block.apply_with_aux
            if self.cfg.remat:
                fn = jax.checkpoint(fn)
            x, a = fn(p, x)
            x = con(x.astype(cdtype))
            aux = aux + a
        x = rms_norm(x.astype(jnp.float32), params["norm_out"])
        logits = jnp.einsum("btd,vd->btv", x, params["embed"])
        return logits, aux / max(1, self.cfg.n_layers)


def lm_loss(model: BitTransformerLM, params, tokens, *,
            aux_coef: float = 0.01, constrain=None):
    """Next-token cross-entropy over ``tokens (B, T)`` (+ MoE balance aux)."""
    logits, aux = model.apply_with_aux(params, tokens, constrain=constrain)
    logits = logits[:, :-1]
    targets = tokens[:, 1:]
    logp = jax.nn.log_softmax(logits, axis=-1)
    ce = -jnp.mean(jnp.take_along_axis(logp, targets[..., None], axis=-1))
    return ce + aux_coef * aux


def make_lm_train_step(model: BitTransformerLM, optimizer, *, constrain=None):
    """Jittable ``(params, opt_state, tokens) -> (params, opt_state, loss)``."""

    def step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: lm_loss(model, p, tokens, constrain=constrain))(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def lm_param_shardings(model: BitTransformerLM, mesh: Mesh,
                       axis: str = "model"):
    """Megatron-style TP specs: QKV/gate/up column-parallel (output features
    on ``axis``), O/down row-parallel (input features on ``axis``), norms and
    embeddings replicated — one psum per attention, one per FFN."""
    col = {"w": P(None, axis), "b": P(axis)}
    row = {"w": P(axis, None), "b": P()}
    block = {"wq": col, "wk": col, "wv": col, "wo": row,
             "norm_attn": P(), "norm_ffn": P()}
    if model.cfg.moe_experts:
        # expert parallelism over the same axis: expert stacks split on
        # their leading E dim, router replicated (models/moe.py)
        block["moe"] = {"router": P(), "w_gate": P(axis, None, None),
                        "w_up": P(axis, None, None),
                        "w_down": P(axis, None, None)}
    else:
        block.update({"w_gate": col, "w_up": col, "w_down": row})
    spec = {"embed": P(), "norm_out": P(),
            "blocks": [block] * model.cfg.n_layers}
    return jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), spec,
        is_leaf=lambda s: isinstance(s, P))


class ExportedTransformerBlock:
    """A trained block frozen into ternary containers, run on the kernel
    registry. A registered pytree: pass it THROUGH jit as an argument
    (``jax.jit(lambda blk, x: blk(x))``) so containers stay literal-free
    (docs/perf.md); attention math stays XLA and fuses around the
    ternary projections."""

    def __init__(self, cfg: BitTransformerConfig, linears: dict,
                 norm_attn, norm_ffn, moe=None, qkv=None,
                 kernel: Optional[str] = None):
        self.cfg = cfg
        self.linears = dict(linears)
        self.norm_attn = jnp.asarray(norm_attn, jnp.float32)
        self.norm_ffn = jnp.asarray(norm_ffn, jnp.float32)
        self.moe = moe  # ExportedMoE for MoE-FFN configs, else None
        #: merged-QKV fast path: {"fmt": container over hstack(Wq,Wk,Wv),
        #: "scale": (3d,) per-segment gammas, "bias": (3d,)} or None
        self.qkv = qkv
        self.kernel = kernel

    @classmethod
    def from_params(cls, cfg: BitTransformerConfig, params: dict,
                    format_cls: Type[TernaryFormat], *,
                    kernel: Optional[str] = None,
                    fused_qkv: bool = False, with_transpose: bool = True,
                    a8: bool = False, **fmt_kwargs):
        moe = None
        if cfg.moe_experts:
            from ternary_spgemm_tpu.models.moe import BitMoEConfig, ExportedMoE

            names = BitTransformerBlock.ATTN_LINEARS
            moe = ExportedMoE.from_params(
                BitMoEConfig(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                             top_k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity_factor),
                params["moe"], format_cls, kernel=kernel, **fmt_kwargs)
        else:
            names = BitTransformerBlock.LINEARS
        linears = {
            n: ExportedBitLinear.from_params(params[n], format_cls,
                                             kernel=kernel,
                                             with_transpose=with_transpose,
                                             a8=a8, **fmt_kwargs)
            for n in names}
        qkv = None
        if fused_qkv:
            qkv = cls._build_fused_qkv(params, format_cls, **fmt_kwargs)
        return cls(cfg, linears, params["norm_attn"], params["norm_ffn"], moe,
                   qkv=qkv, kernel=kernel)

    @staticmethod
    def _build_fused_qkv(params: dict, format_cls, **fmt_kwargs):
        """Merge the q/k/v projections into ONE ternary container over
        ``hstack(Wq, Wk, Wv)`` (d, 3d): one SpMM per attention input instead
        of three, sharing the activation read. The per-tensor absmean
        gammas become a per-SEGMENT output scale (exact — gamma multiplies
        columns); biases concatenate. Serving-only fast path (it bypasses
        the custom-VJP layers)."""
        import numpy as np
        from ternary_spgemm_tpu.models.bitlinear import ternary_quantize

        Ws, scales, biases = [], [], []
        for n in ("wq", "wk", "wv"):
            Wq, g = ternary_quantize(params[n]["w"])
            Wq = np.asarray(Wq, np.int8)
            Ws.append(Wq)
            scales.append(np.full(Wq.shape[1], float(g), np.float32))
            biases.append(np.asarray(params[n]["b"], np.float32))
        fmt = format_cls.from_dense(np.concatenate(Ws, axis=1), **fmt_kwargs)
        return {"fmt": jax.tree_util.tree_map(jnp.asarray, fmt),
                "scale": jnp.asarray(np.concatenate(scales)),
                "bias": jnp.asarray(np.concatenate(biases))}

    def _ffn(self, h):
        """SwiGLU FFN over flattened rows: three registry SpMM calls with
        the silu·mul between them, which XLA fuses."""
        return self.linears["w_down"](
            jax.nn.silu(self.linears["w_gate"](h)) * self.linears["w_up"](h))

    def _qkv(self, h):
        """(rows, d) -> q, k, v, each (rows, d). With the merged container
        (``fused_qkv=True``): ONE SpMM over (d, 3d) + per-segment scale.
        In the A8 regime the shared activation read is also the shared
        requantize: one per-row scale serves all three projections (what
        three separate a8 layers would each recompute)."""
        if self.qkv is not None:
            from ternary_spgemm_tpu.models.exported import _requantize_a8
            from ternary_spgemm_tpu.ops import ternary_spgemm

            d, kvw = self.cfg.d_model, self.cfg.kv_width
            z = jnp.zeros((d + 2 * kvw,), jnp.float32)
            if self._a8:
                from ternary_spgemm_tpu.models.exported import (
                    _default_a8_kernel)

                hq, s = _requantize_a8(h)
                kname = self.kernel or _default_a8_kernel(self.qkv["fmt"],
                                                          h.shape[0])
                out = ternary_spgemm(hq, self.qkv["fmt"], z, None,
                                     kernel=kname)
                out = (out * s) * self.qkv["scale"][None, :] \
                    + self.qkv["bias"][None, :]
            else:
                out = ternary_spgemm(h, self.qkv["fmt"], z, None,
                                     kernel=self.kernel)
                out = out * self.qkv["scale"][None, :] \
                    + self.qkv["bias"][None, :]
            return out[:, :d], out[:, d:d + kvw], out[:, d + kvw:]
        return (self.linears["wq"](h), self.linears["wk"](h),
                self.linears["wv"](h))

    @property
    def _a8(self) -> bool:
        """Whether this block's layers run the W1.58-A8 serving regime
        (decided at export via ``from_params(..., a8=True)``)."""
        lin = self.linears.get("wq")
        return bool(lin is not None and getattr(lin, "a8", False))

    def __call__(self, x):
        B, T, d = x.shape
        flat = lambda n, z: self.linears[n](z.reshape(B * T, -1)).reshape(
            B, T, -1)
        attend = lambda q, k, v: causal_attend(self.cfg.head_tuple, q, k, v,
                                               window=self.cfg.window)
        h = rms_norm(x, self.norm_attn)
        q, kk, v = (z.reshape(B, T, -1)
                    for z in self._qkv(h.reshape(B * T, d)))
        attn = flat("wo", attend(q, kk, v))
        x = x + attn
        h = rms_norm(x, self.norm_ffn)
        if self.moe is not None:
            ffn = self.moe(h)
        else:
            ffn = self._ffn(h.reshape(B * T, d)).reshape(B, T, d)
        return x + ffn


def _unflatten_block(aux, children) -> "ExportedTransformerBlock":
    # Bypass __init__: unflatten must tolerate tracer/sentinel children
    # (jax calls it during tracing, lowering and structure-only transforms).
    obj = object.__new__(ExportedTransformerBlock)
    obj.linears, obj.norm_attn, obj.norm_ffn, obj.moe, obj.qkv = children
    obj.cfg, obj.kernel = aux
    return obj


jax.tree_util.register_pytree_node(
    ExportedTransformerBlock,
    lambda b: ((b.linears, b.norm_attn, b.norm_ffn, b.moe, b.qkv),
               (b.cfg, b.kernel)),
    _unflatten_block)
