"""Serve chip_smoke.py's request storm from several checkouts in turns, on one card.

    python3 chip_turns.py TREE [TREE ...]

Each TREE is a checkout of this repository (for a parent commit: ``git
archive`` unpacked into a directory that ``.gitignore`` lists). For each
TREE in the order given, a child process imports that checkout's
``chip_smoke.py`` and package, builds its kernels, and serves the storm of
chip_smoke's first two serving runs at llama-3-8b width (random weights from
seed 0, quickstart engine options): mixed at ring depth 2, under the sync
gate, then mixed at depth 0. Each run prints its ttft and tokens/s lines;
then the device time of one bf16 decode step (8 rows at lengths 127..2046
and the head, CUDA-graph replay) is taken three times on the same weights.
Give the trees as parent, change, change, parent to compare two versions
within one call. Needs one CUDA card; exits non-zero when a turn fails.
"""

from __future__ import annotations

import os
import subprocess
import sys


def one_turn(tree: str) -> None:
    """The storm at depths 2 and 0 from ``tree``'s own chip_smoke.py."""
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    card = torch.cuda.get_device_name(0)
    cs.log(f"turn {tree}: torch {torch.__version__} on {card}")
    cs._build.build_all()
    with torch.inference_mode():
        engine, ecfg = cs.build_engine("mixed", cs.QUICKSTART)
        requests = cs.storm_requests(engine, ecfg)
        cs.serving_phase(card, "mixed", engine, ecfg, requests,
                         launched=("ragged_paged_attention", "paged_decode_attention"),
                         never=("flash_self_attention",), sync_free=True)
        params = engine.params
        del engine
        torch.cuda.empty_cache()
        engine, ecfg = cs.build_engine("mixed, depth 0", dict(cs.QUICKSTART, decode_lookahead=0),
                                       params)
        cs.serve(engine, [(requests[3][0], cs.SamplingParams(max_tokens=12))], 1)
        cs.serving_phase(card, "mixed, depth 0", engine, ecfg, requests,
                         launched=("ragged_paged_attention", "paged_decode_attention"),
                         never=("flash_self_attention",))
        cfg, rope = engine.model_config, engine.rope_tables
        del engine
        torch.cuda.empty_cache()
        shape = (cfg.num_layers, 321, 64, cfg.num_kv_heads, cfg.head_dim)
        pools = (torch.zeros(shape, dtype=params.dtype, device=params.device),
                 torch.zeros(shape, dtype=params.dtype, device=params.device))
        step = [cs.decode_step_ms(params, rope, pools) for _ in range(3)]
        cs.log(f"turn {tree}: decode step (8 rows, lengths 127..2046, the head; device "
               f"ms) {', '.join(f'{ms:.3f}' for ms in step)}")


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one_turn(sys.argv[2])
        return 0
    if not sys.argv[1:]:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for i, tree in enumerate(sys.argv[1:]):
        print(f"=== turn {i + 1}: {tree}", flush=True)
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
