"""comet_tpu — a hybrid search engine in JAX/XLA, run on an NVIDIA GPU.

A from-scratch rebuild of the capabilities of the Go library wizenheimer/comet
(see SURVEY.md), designed batch-first and array-first for an accelerator:

- Five vector index types: Flat (exact matmul scan), IVF, PQ, IVFPQ and
  HNSW (batched beam search over CSR adjacency).
- BM25 full-text search over CSR postings.
- Metadata filtering with packed bitset planes + bit-sliced indexes (BSI).
- Hybrid search with RRF / weighted-sum / max / min fusion, multi-query
  aggregation, autocut, rerankers.
- Soft deletes, binary serialization, and an LSM-style persistent storage layer.

Where the reference is one-query-at-a-time scalar Go (e.g. the flat scan at
flat_index_search.go:254-274), this engine runs thousands of queries per step as
tiled query x corpus matmuls with fused masking, and scales across devices
with jax.sharding over a 1-D device mesh.
"""

from comet_tpu.types import (
    DistanceKind,
    VectorIndexKind,
    ScoreAggregationKind,
    FusionKind,
    CometError,
    ZeroVectorError,
    DimensionMismatchError,
    NotTrainedError,
    NodeNotFoundError,
    InvalidConfigError,
)
from comet_tpu.core.node import (
    VectorNode,
    MetadataNode,
    new_vector_node,
    new_vector_node_with_id,
    new_metadata_node,
    new_metadata_node_with_id,
)
from comet_tpu.core.results import VectorResult, TextResult, Reranker
from comet_tpu.core.limiter import sanitize_k, limit_results, autocut, autocut_results
from comet_tpu.core.aggregation import (
    aggregate_vector_results,
    aggregate_text_results,
)
from comet_tpu.indexes.flat import FlatIndex
from comet_tpu.indexes.ivf import IVFIndex
from comet_tpu.indexes.pq import PQIndex, calculate_pq_params
from comet_tpu.indexes.ivfpq import IVFPQIndex
from comet_tpu.indexes.hnsw import HNSWIndex, HNSWConfig
from comet_tpu.indexes.bm25 import BM25SearchIndex
from comet_tpu.indexes.metadata import (
    RoaringMetadataIndex,
    Filter,
    FilterGroup,
    MetadataResult,
    eq, ne, gt, gte, lt, lte, range_filter, in_filter, not_in, exists, not_exists,
    not_, between, anyof, noneof, is_null, is_not_null,
)
from comet_tpu.fusion import Fusion, FusionConfig, new_fusion, default_fusion
from comet_tpu.hybrid import HybridSearchIndex, new_hybrid_search_index
from comet_tpu.storage import (
    StorageConfig,
    default_storage_config,
    PersistentHybridIndex,
    open_persistent_hybrid_index,
)

__version__ = "0.1.0"

__all__ = [n for n in dir() if not n.startswith("_")]
