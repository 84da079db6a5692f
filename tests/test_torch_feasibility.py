"""The port's per-device byte plan against the JAX package's (mirror of
``tests/test_feasibility.py``).

``tp_plan`` and ``_read_plan`` of the port take their shapes from the
port's own leaf table and specs, with no ``jax.eval_shape``; given the same
model, tp, quantization and budget they give JAX's numbers exactly: every
per-device and total byte count, the verdict, each leaf's shard shape and
the per-shard read plan. The port's default budget is an H100's 80 GB (on
the card, the card's own memory), where JAX's is a v5e's 16 GiB. At int4 the
port counts its packed bytes (two values a byte), which JAX's ``int4``
arrays count one a byte, so int4 is held to the port's own allocation."""

import json

import pytest
import torch

from cyberfabric_core_tpu.parallel import feasibility as jfeas
from cyberfabric_core_tpu_torch.models import llama
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.parallel import feasibility as feas
from cyberfabric_core_tpu_torch.runtime.quant import quantized_bytes

V5E = 16 * 1024**3
KEYS = ("model", "tp", "quantization", "dtype", "max_batch", "max_seq_len",
        "page_size", "param_bytes_total", "param_bytes_per_device", "kv_bytes_per_device",
        "activation_bytes_estimate", "total_bytes_per_device", "hbm_bytes",
        "hbm_utilization", "fits")

CASES = {
    "70b-int8-tp8": ("llama-3-70b", 8, "int8", {}),
    "70b-int8-tp16": ("llama-3-70b", 16, "int8", {}),
    "70b-bf16-tp8": ("llama-3-70b", 8, "none", {}),
    "70b-bf16-tp16": ("llama-3-70b", 16, "none", {"max_batch": 4}),
    "70b-bf16-tp1": ("llama-3-70b", 1, "none", {}),
    "8b-int8-tp4": ("llama-3-8b", 4, "int8", {"max_seq_len": 2048}),
    "mixtral-int8-tp8": ("mixtral-8x7b", 8, "int8", {}),
    "mixtral-int8-tp2": ("mixtral-8x7b", 2, "int8", {}),
    "8b-bf16-tp2": ("llama-3-8b", 2, "none", {"max_seq_len": 2048, "num_pages": 257}),
    "8b-bf16-tp8": ("llama-3-8b", 8, "none", {"max_seq_len": 2048}),
    "qwen2-bias-tp2": ("tiny-qwen2-golden", 2, "int8", {}),
    "tiny-replicated-tp8": ("tiny-llama", 8, "none", {"kv_replicated": True}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_equals_jax_at_the_same_budget(name):
    model, tp, quant, kw = CASES[name]
    want = jfeas.tp_plan(model, tp, quantization=quant, hbm_bytes=V5E, **kw)
    got = feas.tp_plan(model, tp, quantization=quant, hbm_bytes=V5E, **kw)
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert got["read_plan"] == want["read_plan"]

    def leaves(plan):
        return {row["leaf"]: (row["shape"], row["dtype"], row["shard_shape"],
                              row["bytes_per_device"]) for row in plan["leaves"]}
    assert leaves(got) == leaves(want)


def test_default_budget_is_the_h100s():
    plan = feas.tp_plan("llama-3-70b", 8, quantization="int8")
    assert plan["hbm_bytes"] == feas.H100_HBM_BYTES == 80 * 10**9
    assert feas.card_hbm_bytes("cpu") == feas.H100_HBM_BYTES
    assert plan["fits"] and plan["hbm_utilization"] < 0.25


def test_gate_refuses_70b_bf16_on_one_card_as_jax_words_it():
    """llama-3-70b bf16 at tp=1 cannot fit one 80 GB card: the gate raises
    the typed error, JAX's message at the same budget; int8 at tp=8 fits,
    enforced."""
    with pytest.raises(feas.InfeasiblePlanError) as got:
        feas.gate_engine_plan("llama-3-70b", 1, hbm_bytes=feas.H100_HBM_BYTES)
    with pytest.raises(jfeas.InfeasiblePlanError) as want:
        jfeas.gate_engine_plan("llama-3-70b", 1, hbm_bytes=feas.H100_HBM_BYTES)
    assert str(got.value) == str(want.value)
    # JAX's plan also names its expert-parallel degree, an axis the port has
    # not; the port's adds the bytes each rank holds (one rank here)
    plan = dict(got.value.plan)
    assert plan.pop("param_bytes_per_rank") == [plan["param_bytes_per_device"]]
    assert plan == {k: v for k, v in want.value.plan.items() if k != "ep"}
    plan = feas.gate_engine_plan("llama-3-70b", 8, quantization="int8",
                                 hbm_bytes=feas.H100_HBM_BYTES)
    assert plan["fits"] is True and plan["enforced"] is True
    unenforced = feas.gate_engine_plan("llama-3-70b", 1)
    assert unenforced["enforced"] is False and unenforced["fits"] is False


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_tp1_equals_the_ports_allocated_bytes(quant):
    """At tp=1 the plan's parameter bytes are the bytes of the tree the port
    draws, to the byte (int4 packed); bf16 also equals JAX's unsharded
    count."""
    cfg = get_config("tiny-llama")
    bits = {"none": None, "int8": 8, "int4": 4}[quant]
    model = llama.init_params(cfg, 0, torch.bfloat16, "cpu", quant_bits=bits)
    plan = feas.tp_plan("tiny-llama", 1, quantization=quant, max_seq_len=128, max_batch=2)
    assert plan["param_bytes_per_device"] == plan["param_bytes_total"] == \
        quantized_bytes(model)
    if quant == "none":
        want = jfeas.tp_plan("tiny-llama", 1, max_seq_len=128, max_batch=2)
        assert plan["param_bytes_total"] == want["param_bytes_total"]


def test_indivisible_kv_heads_rejected():
    with pytest.raises(ValueError, match="kv_heads"):
        feas.tp_plan("llama-3-8b", 3)


def test_kv_cache_shards_on_tp():
    p4 = feas.tp_plan("llama-3-8b", 4, quantization="int8", max_seq_len=2048)
    p8 = feas.tp_plan("llama-3-8b", 8, quantization="int8", max_seq_len=2048)
    assert p4["kv_bytes_per_device"] == 2 * p8["kv_bytes_per_device"]


def test_cli_prints_the_plan(capsys):
    assert feas.main(["--model", "llama-3-70b", "--tp", "8", "--quant", "int8"]) == 0
    report = json.loads(capsys.readouterr().out)
    want = jfeas.tp_plan("llama-3-70b", 8, quantization="int8", hbm_bytes=feas.H100_HBM_BYTES)
    assert "leaves" not in report and report["fits"] is True
    assert report["total_bytes_per_device"] == want["total_bytes_per_device"]
    assert report["hbm_utilization"] == want["hbm_utilization"]
