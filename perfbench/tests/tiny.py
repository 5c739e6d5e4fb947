"""A copy of the benchmark with tiny cells added, for tests on the CPU: the
port's two served families at a few dozen widths, in float32, under a
short serve mix. Added as files and entries, as a later change would add
a cell."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.harness import registry

HYBRID = {"name": "tiny-hybrid", "family": "hybrid", "n_layers": 2,
          "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
          "d_ff": 128, "vocab": 256, "ssm_state": 16, "ssm_heads": 4,
          "ssm_head_dim": 16, "ssm_chunk": 8, "attn_window": 16,
          "dtype": "float32"}
# groups of 16 at capacity factor 1.0 drop slots in the prefill, and a
# decode step's group of one token a row keeps one place an expert
MOE = {"name": "tiny-moe", "family": "moe", "n_layers": 2, "d_model": 64,
       "n_heads": 4, "n_kv_heads": 4, "head_dim": 16, "d_ff": 32,
       "vocab": 256, "n_experts": 4, "n_shared_experts": 2, "top_k": 2,
       "capacity_factor": 1.0, "moe_group": 16, "moe_impl": "einsum",
       "dtype": "float32"}
MODELS = {"tiny_hybrid": HYBRID, "tiny_moe": MOE}
TRAFFIC = {"kind": "serve", "batch": 3, "prompt_len": 40, "decode_steps": 4,
           "check_batches": 2, "why": "tests"}
TRAIN = {"kind": "train", "global_batch": 2, "seq_len": 24, "check_steps": 3,
         "why": "tests"}
LIMIT = 1e-3      # float32 on both sides: argmax ties at most
# float32 on both sides, the leaves stored in float32: round-off only
TRAIN_LIMITS = {"loss_gap": 1e-5, "grad_norm_gap": 1e-4, "change_gap": 1e-4}
TRAIN_CELL = "tiny_hybrid.tiny_train"


def cell_name(config: str) -> str:
    return f"{config}.tiny_serve"


def make_root(dest: Path) -> Path:
    """The benchmark copied under ``dest`` with the tiny cells added."""
    dest = Path(dest)
    shutil.copytree(registry.ROOT / "perfbench", dest / "perfbench")
    bench = registry.load_benchmark()
    (dest / "perfbench" / "traffic" / "tiny_serve.json").write_text(
        json.dumps(TRAFFIC))
    (dest / "perfbench" / "traffic" / "tiny_train.json").write_text(
        json.dumps(TRAIN))
    (dest / "perfbench" / "limits" / f"{TRAIN_CELL}.json").write_text(
        json.dumps({k: {"limit": v} for k, v in TRAIN_LIMITS.items()}))
    bench["workloads"].append({"name": TRAIN_CELL, "config": "tiny_hybrid",
                               "traffic": "tiny_train", "chips": 1,
                               "why": "tests"})
    for name, model in MODELS.items():
        (dest / "perfbench" / "configs" / f"{name}.json").write_text(
            json.dumps({"name": name, "model": model}))
        (dest / "perfbench" / "limits" / f"{cell_name(name)}.json"
         ).write_text(json.dumps({"served_token_gap": {"limit": LIMIT},
                                  "served_token_gap_mean": {"limit": LIMIT}}))
        bench["configs"].append({"name": name, "source": "tests",
                                 "file": f"perfbench/configs/{name}.json",
                                 "reduced": [], "why": "tests"})
        bench["workloads"].append({"name": cell_name(name), "config": name,
                                   "traffic": "tiny_serve", "chips": 1,
                                   "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        ws = m.get("workloads", [])
        if any(".serve_" in w for w in ws):
            ws += [cell_name(name) for name in MODELS]
        if any(w.endswith(".train_b4_s4096") for w in ws):
            ws.append(TRAIN_CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest
