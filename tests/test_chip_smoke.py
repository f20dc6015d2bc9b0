"""chip_smoke.py's phases on the CPU at test size, and its refusal to run
without a GPU.

The serve phase's comparison here is served logits against the plain
float32 reference (``reference.ternary_lm_logits``) on the ``test``
preset's widths. Of its controls, the TF32 reference separates only on a
GPU, where TF32 exists; the others are checked here too."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TEST = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2)


@pytest.mark.parametrize("overrides,cache", [
    pytest.param({}, "float32", id="mha"),
    pytest.param({"n_kv_heads": 2}, "float32", id="gqa"),
    pytest.param({}, "int8", id="int8-cache"),
    pytest.param({"window": 6}, "float32", id="sliding-window"),
])
def test_serve_phase_matches_reference(overrides, cache):
    from ternary_spgemm_tpu.models import BitTransformerConfig

    cfg = BitTransformerConfig(**{**TEST, **overrides})
    errs = chip_smoke.phase_serve(cfg, batch=2, prompt_len=8, n_new=4,
                                  cache_dtypes=(cache,), controls=())
    assert errs[cache] <= chip_smoke.SERVE_MEDIAN_TOL


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_serve_phase_rejects_wrong_references(cache):
    """The activation quantization and the KV cache's rounding each move
    every row past the median bound, so references without them fail (at
    one layer, and wide enough that a row's maximum is taken over many
    logits, as at the 3B's widths)."""
    from ternary_spgemm_tpu.models import BitTransformerConfig

    cfg = BitTransformerConfig(vocab=512, d_model=256, n_heads=4, d_ff=512,
                               n_layers=1)
    controls = ("no activation quantization", "the other KV cache's rounding")
    errs = chip_smoke.phase_serve(cfg, batch=2, prompt_len=8, n_new=4,
                                  cache_dtypes=(cache,), controls=controls)
    for label in controls:
        assert errs[f"{cache} control:{label}"] > chip_smoke.SERVE_MEDIAN_TOL


def test_serve_phase_ring_cache():
    from ternary_spgemm_tpu.models import BitTransformerConfig

    cfg = BitTransformerConfig(**{**TEST, "window": 8})
    errs = chip_smoke.phase_serve(cfg, batch=2, prompt_len=8, n_new=4,
                                  cache_dtypes=("float32",), ring=True,
                                  controls=())
    assert errs["float32"] <= chip_smoke.SERVE_MEDIAN_TOL


def test_kernel_phase_interpreted():
    errs = chip_smoke.phase_kernels(shapes=(("t", 300, 260),), rows=(1, 20),
                                    interpret=True)
    assert len(errs) == 2 * len(chip_smoke.KERNEL_PRECISION)
    assert max(errs.values()) <= chip_smoke.KERNEL_TOL


def test_four_card_phase_on_virtual_devices():
    errs = chip_smoke.phase_four_cards(d_model=256, d_ff=512, rows=4)
    assert set(errs) == {
        "lm_train_step loss", "lm_train_step params",
        "column_sharded_spgemm", "overlapped_gather_spgemm",
        "row_sharded_spgemm",
        "tensor_parallel_fused_swiglu (mean, of max|y|)",
        "tensor_parallel_fused_swiglu (max, of max|y|)"}


def _run(cmd, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            pass
    return False


def test_main_fails_without_gpu():
    out = _run([sys.executable, "chip_smoke.py"], REPO)
    assert out.returncode != 0
    assert not _has_result(out.stdout)


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run([sys.executable, "chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert not _has_result(out.stdout)
