from repro_torch.train.embedding_cache import (
    EmbedCacheStats,
    TieredEmbeddingStore,
    init_tables,
    make_store_for_model,
)
from repro_torch.train.trainer import StepMetrics, Trainer, TrainerConfig, TrainMetrics

__all__ = [
    "EmbedCacheStats", "TieredEmbeddingStore", "init_tables", "make_store_for_model",
    "StepMetrics", "Trainer", "TrainerConfig", "TrainMetrics",
]
