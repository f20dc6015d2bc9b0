"""Ternary Mixture-of-Experts: BitNet experts + GShard-style dispatch (EP).

Net-new vs the reference (SURVEY.md §2.3: no parallelism of any kind there);
this supplies the **expert-parallel** leg of the dp/tp/pp/sp/ep matrix. Each
expert is a BitNet SwiGLU FFN (latent-f32 weights ternarized through the
straight-through estimator each forward — the same QAT regime as
:class:`~ternary_spgemm_tpu.models.bitlinear.BitLinear`), so every expert's
deployed form is exactly the reference's ternary SpMM operand
(``readme.md:84-85`` flop model; generator semantics ``sparseUtils.h:26-90``).

Routing is the static-shape GShard/Switch formulation: top-k router
probabilities become *dense one-hot dispatch/combine tensors* and the
token→expert shuffle is two einsums — no sorting, no ragged shapes, static
everything. Under GSPMD with the expert dimension sharded over a mesh axis,
those einsums lower to exactly the all_to_all pair a hand-written MoE would
issue. Tokens beyond an expert's static capacity are
dropped (output 0 — the residual connection carries them), the standard
Switch-Transformer contract.

All shapes are static under jit: capacity ``C`` is computed from the static
token count, the per-expert position comes from a cumsum, and the expert
stack applies as one batched einsum over the leading ``E`` axis — one dot
per projection for ALL experts.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ternary_spgemm_tpu.models.bitlinear import ternary_quantize_ste


@dataclasses.dataclass(frozen=True)
class BitMoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 1
    capacity_factor: float = 1.5

    def __post_init__(self):
        if self.top_k < 1 or self.top_k > self.n_experts:
            raise ValueError(f"top_k={self.top_k} outside 1..{self.n_experts}")

    def capacity(self, n_tokens: int) -> int:
        """Static per-expert slot count for ``n_tokens`` routed ``top_k`` ways."""
        c = math.ceil(self.capacity_factor * self.top_k * n_tokens
                      / self.n_experts)
        return max(4, min(n_tokens, c))


def moe_route(cfg: BitMoEConfig, router_w, xs):
    """Top-k dispatch/combine tensors for flat tokens ``xs (S, d)``.

    Returns ``(dispatch (S,E,C) f32 0/1, combine (S,E,C) f32, aux)``.
    Per top-k round: pick each token's best remaining expert, assign
    capacity slots in token order by per-expert cumsum, drop overflow.
    Shared by the QAT layer and :class:`ExportedMoE`.
    """
    S, E = xs.shape[0], cfg.n_experts
    C = cfg.capacity(S)
    logits = jnp.dot(xs, router_w, preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)            # (S, E)

    # Switch aux loss uses the FIRST-choice assignment fractions.
    mask1 = jax.nn.one_hot(jnp.argmax(probs, -1), E, dtype=jnp.float32)
    aux = E * jnp.mean(
        jnp.mean(mask1, axis=0) * jnp.mean(probs, axis=0)) * E

    remaining = probs
    fill = jnp.zeros((E,), jnp.float32)                # slots used so far
    dispatch = jnp.zeros((S, E, C), jnp.float32)
    combine = jnp.zeros((S, E, C), jnp.float32)
    for _ in range(cfg.top_k):                         # static, tiny
        choice = jnp.argmax(remaining, axis=-1)        # (S,)
        gate = jnp.take_along_axis(probs, choice[:, None], -1)[:, 0]
        mask = jax.nn.one_hot(choice, E, dtype=jnp.float32)   # (S, E)
        pos = fill[None, :] + jnp.cumsum(mask, axis=0) - mask  # slot index
        keep = mask * (pos < C)
        slot = jax.nn.one_hot(pos.astype(jnp.int32), C,
                              dtype=jnp.float32)       # (S, E, C)
        d_k = keep[:, :, None] * slot
        dispatch = dispatch + d_k
        combine = combine + d_k * gate[:, None, None]
        fill = fill + jnp.sum(keep, axis=0)
        remaining = remaining * (1.0 - mask)           # exclude chosen
    return dispatch, combine, aux


class BitMoE:
    """Functional ternary-expert MoE layer.

    Params: ``{"router": (d, E) f32}`` plus stacked latent expert weights
    ``{"w_gate": (E, d, ff), "w_up": (E, d, ff), "w_down": (E, ff, d)}``.
    ``apply`` returns ``(y, aux)`` where ``aux`` is the Switch load-balancing
    loss (E · Σ_e fraction_e · mean-prob_e; 1.0 = perfectly balanced).
    """

    def __init__(self, cfg: BitMoEConfig):
        self.cfg = cfg

    def init(self, key) -> dict:
        cfg = self.cfg
        kr, kg, ku, kd = jax.random.split(key, 4)
        sd = (2.0 / cfg.d_model) ** 0.5
        sf = (2.0 / cfg.d_ff) ** 0.5
        E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
        return {
            "router": jax.random.normal(kr, (d, E), jnp.float32) * d ** -0.5,
            "w_gate": jax.random.normal(kg, (E, d, ff), jnp.float32) * sd,
            "w_up": jax.random.normal(ku, (E, d, ff), jnp.float32) * sd,
            "w_down": jax.random.normal(kd, (E, ff, d), jnp.float32) * sf,
        }

    def _route(self, params, xs):
        return moe_route(self.cfg, params["router"], xs)

    def apply(self, params: dict, x, *, expert_sharding=None):
        """``x (..., d) -> (y (..., d), aux scalar)``.

        ``expert_sharding``: optional ``NamedSharding``/``PartitionSpec`` with
        the expert axis leading (e.g. ``P("expert", None, None)``); applied to
        the dispatched expert batch so GSPMD materializes the all_to_all onto
        that mesh axis even before the einsum touches the (already-sharded)
        expert weights.
        """
        d = x.shape[-1]
        xs = x.reshape(-1, d)
        dispatch, combine, aux = self._route(params, xs)
        # dispatch/combine ride at the compute dtype (bf16 policy: the 0/1
        # dispatch is exact, the combine gates lose <2^-8 relative)
        dispatch = dispatch.astype(xs.dtype)
        combine = combine.astype(xs.dtype)
        expert_in = jnp.einsum("sec,sd->ecd", dispatch, xs)      # a2a #1
        if expert_sharding is not None:
            expert_in = jax.lax.with_sharding_constraint(
                expert_in, expert_sharding)
        # per-EXPERT absmean gamma (each expert is its own BitNet matrix);
        # quantize at master f32 precision, compute at x's dtype
        quant = jax.vmap(ternary_quantize_ste)
        wq = {n: quant(params[n]).astype(x.dtype)
              for n in ("w_gate", "w_up", "w_down")}
        h = jnp.einsum("ecd,edf->ecf", expert_in, wq["w_gate"])
        u = jnp.einsum("ecd,edf->ecf", expert_in, wq["w_up"])
        h = jax.nn.silu(h) * u
        out = jnp.einsum("ecf,efd->ecd", h, wq["w_down"])
        if expert_sharding is not None:
            out = jax.lax.with_sharding_constraint(out, expert_sharding)
        y = jnp.einsum("sec,ecd->sd", combine, out)              # a2a #2
        return y.reshape(x.shape), aux


class ExportedMoE:
    """A trained :class:`BitMoE` frozen into ternary containers — the MoE
    serving path. The router stays f32 (it is tiny: d×E); every expert's
    gate/up/down matrix becomes a registered container + absmean gamma and
    runs through the SpMM kernel registry
    (:class:`~ternary_spgemm_tpu.models.exported.ExportedBitLinear`, so the
    frozen experts are differentiable w.r.t. their inputs too).

    The expert loop is a static Python loop (E kernel-call triples under
    one jit) — each expert's containers ride as pytree leaves, never as
    closure captures (docs/perf.md). A registered pytree: pass the
    layer THROUGH jit as an argument.
    """

    def __init__(self, cfg: BitMoEConfig, router, experts):
        self.cfg = cfg
        self.router = jnp.asarray(router, jnp.float32)
        self.experts = list(experts)   # [{"w_gate","w_up","w_down"}: ExportedBitLinear]

    @classmethod
    def from_params(cls, cfg: BitMoEConfig, params: dict, format_cls, *,
                    kernel=None, **fmt_kwargs):
        from ternary_spgemm_tpu.models.exported import ExportedBitLinear

        experts = []
        for e in range(cfg.n_experts):
            experts.append({
                n: ExportedBitLinear.from_params(
                    {"w": params[n][e],
                     "b": jnp.zeros((params[n][e].shape[1],), jnp.float32)},
                    format_cls, kernel=kernel, **fmt_kwargs)
                for n in ("w_gate", "w_up", "w_down")})
        return cls(cfg, params["router"], experts)

    def __call__(self, x):
        d = x.shape[-1]
        xs = x.reshape(-1, d)
        dispatch, combine, _ = moe_route(self.cfg, self.router, xs)
        expert_in = jnp.einsum("sec,sd->ecd", dispatch, xs)
        outs = []
        for e, ex in enumerate(self.experts):
            h = jax.nn.silu(ex["w_gate"](expert_in[e])) * ex["w_up"](expert_in[e])
            outs.append(ex["w_down"](h))
        y = jnp.einsum("sec,ecd->sd", combine, jnp.stack(outs))
        return y.reshape(x.shape)


jax.tree_util.register_pytree_node(
    ExportedMoE,
    lambda m: ((m.router, m.experts), m.cfg),
    lambda cfg, ch: ExportedMoE(cfg, ch[0], ch[1]))


def moe_param_shardings(mesh: Mesh, axis: str = "expert"):
    """Expert-parallel specs: expert stacks split on their leading E axis,
    router replicated (every device routes its own tokens)."""
    spec = {"router": P(),
            "w_gate": P(axis, None, None), "w_up": P(axis, None, None),
            "w_down": P(axis, None, None)}
    return jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), spec,
        is_leaf=lambda s: isinstance(s, P))
