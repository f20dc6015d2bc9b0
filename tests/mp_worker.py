"""Multi-process distributed worker — spawned by tests/test_multiprocess.py.

One OS process per "host": ``jax.distributed.initialize`` over a localhost
coordinator, 4 virtual CPU devices per process (``XLA_FLAGS`` set by the
spawner), gloo cross-process collectives. Exercises the DCN-boundary code
paths single-process CPU meshes never touch (SURVEY.md §4:236-240):

* global arrays assembled from per-process data
  (``jax.make_array_from_process_local_data``);
* ternary containers built per-process from ONLY the local weight shard
  (``parallel.container_from_local_shard`` — no process holds full W);
* collectives (psum / psum_scatter / ppermute ring) spanning the process
  boundary in all three sharded SpMM schemes;
* a sharded LM train step whose gradient psum crosses processes;
* checkpoint save→restore where each process reads/writes only its own
  shard file (``checkpoint.save_sharded_pytree``).

Markers print from process 0 only; the spawner asserts them. Not a pytest
module (no ``test_`` prefix) — invoked as a script:
``python mp_worker.py <pid> <nproc> <port> <tmpdir>``.
"""

import sys

PID, NPROC, PORT, TMPDIR = (int(sys.argv[1]), int(sys.argv[2]),
                            sys.argv[3], sys.argv[4])
sys.path.insert(0, sys.argv[5] if len(sys.argv) > 5 else ".")

import jax  # noqa: E402

# CPU, as in tests/conftest.py; gloo is the CPU cross-process collective
# backend.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{PORT}",
                           num_processes=NPROC, process_id=PID)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from ternary_spgemm_tpu import checkpoint  # noqa: E402
from ternary_spgemm_tpu.formats import (  # noqa: E402
    DenseTernary, PackedTernary53, generate_bias, generate_ternary,
    generate_x)
from ternary_spgemm_tpu.parallel import (  # noqa: E402
    column_sharded_spgemm, container_from_local_shard, make_mesh,
    overlapped_gather_spgemm, row_sharded_spgemm)


def mark(msg: str) -> None:
    if jax.process_index() == 0:
        print(f"MPMARK {msg}", flush=True)


def local_shards_match(y, ref, atol=1e-5) -> None:
    """Assert every addressable shard of the global array matches the
    corresponding slice of the full (verification-only) reference."""
    for sh in y.addressable_shards:
        np.testing.assert_allclose(np.asarray(sh.data),
                                   np.asarray(ref[sh.index]), atol=atol)


assert jax.process_count() == NPROC, jax.process_count()
n_dev = len(jax.devices())
n_local = len(jax.local_devices())
assert n_dev == NPROC * n_local, (n_dev, n_local)
mark(f"init process_count={NPROC} devices={n_dev} local={n_local}")

mesh = make_mesh({"model": n_dev})
rep = NamedSharding(mesh, P(None, None))

# ---- scheme 1: column-parallel SpMM, container built from LOCAL columns ----
K, N = 64, 32 * n_dev
W = generate_ternary(K, N, 4, seed=0)           # verification-only full W
cols = slice(PID * (N // NPROC), (PID + 1) * (N // NPROC))
fmt = container_from_local_shard(
    PackedTernary53.from_dense(W[:, cols]), mesh, "model", dim="N", K=K, N=N)
X = jax.make_array_from_process_local_data(
    rep, np.asarray(generate_x(8, K, seed=1), np.float32), (8, K))
bias = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("model")),
    np.asarray(generate_bias(N)[cols], np.float32), (N,))
ref = np.asarray(generate_x(8, K, seed=1), np.float32) @ \
    np.asarray(W, np.float32) + np.asarray(generate_bias(N), np.float32)
y = column_sharded_spgemm(X, fmt, bias, mesh=mesh, axis="model")
local_shards_match(y, ref)
mark("scheme OK: column_sharded_spgemm (per-process container shards)")

# ---- scheme 2: row-parallel + psum_scatter across the process boundary ----
Kr = 32 * n_dev
rows = slice(PID * (Kr // NPROC), (PID + 1) * (Kr // NPROC))
Wr = generate_ternary(Kr, 64, 4, seed=2)
fmt_r = container_from_local_shard(
    DenseTernary.from_dense(Wr[rows, :]), mesh, "model", dim="K", K=Kr, N=64)
Xr_full = np.asarray(generate_x(8, Kr, seed=3), np.float32)
Xr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P(None, "model")), Xr_full[:, rows], (8, Kr))
br_full = np.asarray(generate_bias(64), np.float32)
br = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("model")), br_full[64 // NPROC * PID:
                                             64 // NPROC * (PID + 1)], (64,))
ref_r = Xr_full @ np.asarray(Wr, np.float32) + br_full
y_r = row_sharded_spgemm(Xr, fmt_r, br, mesh=mesh, axis="model",
                         scatter_output=True)
local_shards_match(y_r, ref_r)
mark("scheme OK: row_sharded_spgemm(psum_scatter across processes)")

# ---- scheme 3: overlapped ppermute ring crossing the DCN boundary ----
Mo = 2 * n_dev
Wo = generate_ternary(64, 32 * n_dev, 4, seed=4)
fmt_o = container_from_local_shard(          # same N as scheme 1 -> same cols
    PackedTernary53.from_dense(Wo[:, cols]), mesh, "model", dim="N",
    K=64, N=32 * n_dev)
Xo_full = np.asarray(generate_x(Mo, 64, seed=5), np.float32)
mrows = slice(PID * (Mo // NPROC), (PID + 1) * (Mo // NPROC))
Xo = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("model", None)), Xo_full[mrows], (Mo, 64))
bo_full = np.asarray(generate_bias(32 * n_dev), np.float32)
bo = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("model")),
    bo_full[PID * (32 * n_dev // NPROC):(PID + 1) * (32 * n_dev // NPROC)],
    (32 * n_dev,))
ref_o = Xo_full @ np.asarray(Wo, np.float32) + bo_full
y_o = overlapped_gather_spgemm(Xo, fmt_o, bo, mesh=mesh, axis="model")
local_shards_match(y_o, ref_o)
mark("scheme OK: overlapped_gather_spgemm (ppermute ring across processes)")

# ---- sharded LM train step: gradient psum spans processes ----
import optax  # noqa: E402

from ternary_spgemm_tpu.models import TernaryMLP, make_sharded_train_step  # noqa: E402

mesh2 = make_mesh({"data": 2, "model": n_dev // 2})
tp = n_dev // 2
feats = [8 * tp, 16 * tp, 8 * tp]
model = TernaryMLP(feats)
params = model.init(jax.random.key(0))
optimizer = optax.adam(1e-3)
opt_state = optimizer.init(params)
step, place = make_sharded_train_step(model, optimizer, mesh2)
xb = jnp.ones((8, feats[0]), jnp.float32)
yb = jnp.zeros((8, feats[-1]), jnp.float32)
params, opt_state, xb, yb = place(params, opt_state, xb, yb)
params, opt_state, loss = step(params, opt_state, xb, yb)
jax.block_until_ready(loss)
lv = float(np.asarray(jax.device_get(loss)))
assert np.isfinite(lv), lv
mark(f"scheme OK: sharded LM train step (dp x tp, loss={lv:.4f})")

# ---- checkpoint: each process saves/restores ONLY its own shards ----
state = {"params": params, "opt": opt_state, "step": jnp.int32(1)}
path = f"{TMPDIR}/mp_ckpt"
checkpoint.save_sharded_pytree(path, state)
# all shard files must exist before any process restores
import jax.experimental.multihost_utils as mhu  # noqa: E402
mhu.sync_global_devices("ckpt_saved")
restored = checkpoint.restore_sharded_pytree(path, state)
for a, b in zip(jax.tree_util.tree_leaves(state),
                jax.tree_util.tree_leaves(restored)):
    a, b = checkpoint.jnp_asarray(a), checkpoint.jnp_asarray(b)
    for sa, sb in zip(a.addressable_shards, b.addressable_shards):
        np.testing.assert_array_equal(np.asarray(sa.data),
                                      np.asarray(sb.data))
mark("scheme OK: sharded checkpoint save/restore (per-process shard files)")

mhu.sync_global_devices("done")
jax.distributed.shutdown()
mark("shutdown clean")
