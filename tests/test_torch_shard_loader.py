"""The port's sharded checkpoint loader against the JAX package's (mirror
of ``tests/test_shard_loader.py``).

At a tiny geometry: the synthesized checkpoint has the HF sharded layout of
JAX's (and JAX's loader reads it); executing the read plan lands exactly the
bytes each rank must read, the very arrays JAX's loader stages from the same
checkpoint; a load killed part way (``os._exit`` after nine items) resumes
from its manifest without reading those items again; and
``checkpoint_size_bytes`` is JAX's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cyberfabric_core_tpu.models.configs import ModelConfig as JModelConfig
from cyberfabric_core_tpu.runtime import shard_loader as jloader
from cyberfabric_core_tpu.runtime.weights import checkpoint_size_bytes as jsize
from cyberfabric_core_tpu_torch.models.configs import ModelConfig
from cyberfabric_core_tpu_torch.parallel.feasibility import tp_plan
from cyberfabric_core_tpu_torch.runtime import shard_loader
from cyberfabric_core_tpu_torch.runtime.weights import checkpoint_size_bytes

TP = 4
GEOMETRY = dict(name="loader-test", architecture="llama", vocab_size=256, hidden_size=64,
                intermediate_size=128, num_layers=3, num_heads=8, num_kv_heads=4,
                head_dim=8, max_position=64, rope_theta=10000.0)
CFG = ModelConfig(**GEOMETRY)
JCFG = JModelConfig(**GEOMETRY)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def plan():
    return tp_plan(CFG, TP)["read_plan"]


def test_synthesized_checkpoint_is_jaxs_sharded_layout(tmp_path):
    out = shard_loader.synthesize_hf_checkpoint(CFG, tmp_path / "ckpt", max_shard_bytes=40_000)
    assert len(sorted(out.glob("*.safetensors"))) > 1  # the cap forces several files
    index = json.loads((out / "model.safetensors.index.json").read_text())
    assert shard_loader.hf_tensor_shapes(CFG) == jloader.hf_tensor_shapes(JCFG)
    assert set(index["weight_map"]) == set(jloader.hf_tensor_shapes(JCFG))
    assert checkpoint_size_bytes(out) == jsize(out)


def test_read_plan_lands_exact_per_rank_bytes_as_jax(tmp_path, plan):
    ckpt = shard_loader.synthesize_hf_checkpoint(CFG, tmp_path / "ckpt", seed=0)
    stats = shard_loader.execute_read_plan(ckpt, plan, CFG, TP, tmp_path / "stage", workers=3)
    assert stats["items_skipped_resume"] == 0
    expected = shard_loader.expected_rank_bytes(plan, CFG, TP)
    assert expected == jloader.expected_rank_bytes(plan, JCFG, TP)
    assert shard_loader.staged_rank_bytes(tmp_path / "stage", TP) == [expected] * TP
    jloader.execute_read_plan(ckpt, plan, JCFG, TP, tmp_path / "jstage", workers=3)
    for rank in range(TP):
        files = sorted(p.name for p in (tmp_path / "stage" / f"rank{rank}").glob("*.npy"))
        assert files == sorted(p.name for p in (tmp_path / "jstage" / f"rank{rank}").glob("*.npy"))
        for name in files:
            a = np.load(tmp_path / "stage" / f"rank{rank}" / name)
            b = np.load(tmp_path / "jstage" / f"rank{rank}" / name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (rank, name)
    q0 = np.load(tmp_path / "stage" / "rank0" / "model.layers.0.self_attn.q_proj.weight.npy")
    full = shard_loader.hf_tensor_shapes(CFG)["model.layers.0.self_attn.q_proj.weight"]
    assert q0.shape == (full[0] // TP, full[1])


def test_crash_mid_load_resumes_from_manifest(tmp_path, plan):
    ckpt = shard_loader.synthesize_hf_checkpoint(CFG, tmp_path / "ckpt", seed=1)
    stage = tmp_path / "stage"
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(json.dumps(plan))
    code = (
        "import json\n"
        "from cyberfabric_core_tpu_torch.models.configs import ModelConfig\n"
        "from cyberfabric_core_tpu_torch.runtime import shard_loader\n"
        f"cfg = ModelConfig(**{GEOMETRY!r})\n"
        f"plan = json.load(open({str(plan_file)!r}))\n"
        f"shard_loader.execute_read_plan({str(ckpt)!r}, plan, cfg, {TP}, {str(stage)!r}, "
        "workers=2, interrupt_after_items=9)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 41, proc.stderr[-500:]  # ended as planned
    assert len((stage / "manifest.jsonl").read_text().splitlines()) >= 9

    stats = shard_loader.execute_read_plan(ckpt, plan, CFG, TP, stage, workers=2)
    assert stats["items_skipped_resume"] >= 9
    assert stats["items_read"] + stats["items_skipped_resume"] == stats["items_total"]
    expected = jloader.expected_rank_bytes(plan, JCFG, TP)
    assert shard_loader.staged_rank_bytes(stage, TP) == [expected] * TP
