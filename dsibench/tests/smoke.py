"""Sizes at which a run of each cell fits a CPU test, as overrides of the
cell's configuration and traffic (``harness.run_cell(overrides=...)``).
The LM runs in float32 here: at smoke widths bf16 rounding is a larger
share of each leaf than at the published widths the limits were read
at, and the CPU test holds the port's path, not its bf16 rounding (the
card's runs hold that)."""
DLRM = {"config": {"model": {"num_dense": 16, "num_tables": 8, "vocab_per_table": 1000,
                             "embed_dim": 16, "max_ids_per_feature": 8,
                             "bottom_mlp": [32, 16], "top_mlp": [64, 32, 1]}},
        "traffic": {"batch": 64, "pool": 3, "workers": 2, "stripe_rows": 32,
                    "warmup_steps": 2}}
LM_MODEL = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
            "head_dim": 16, "d_ff": 128, "vocab_size": 512, "param_dtype": "float32",
            "compute_dtype": "float32"}
LM_TRAFFIC = {"partitions": 8, "docs_per_partition": 120, "mean_len": 64, "stripe_rows": 16,
              "warmup_steps": 1}
OVERRIDES = {
    "dlrm-paper.train.b4096": DLRM,
    "qwen3-8b.train.s4096": {"config": {"model": LM_MODEL},
                             "traffic": dict(LM_TRAFFIC, rows=2, seq=64)},
    "qwen3-8b.train.s512": {"config": {"model": LM_MODEL},
                            "traffic": dict(LM_TRAFFIC, rows=4, seq=32)},
}
CELLS = sorted(OVERRIDES)
SEED = 2 ** 31 + 11
