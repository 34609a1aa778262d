"""End-to-end demo: hybrid product search with durable storage.

Run: python examples/hybrid_demo.py        (works on CPU or GPU)
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from comet_tpu import (
    BM25SearchIndex,
    DistanceKind,
    FlatIndex,
    FusionKind,
    RoaringMetadataIndex,
    eq,
    gte,
    lte,
    new_hybrid_search_index,
)
from comet_tpu.storage import StorageConfig, open_persistent_hybrid_index

DIM = 64
rng = np.random.default_rng(7)

PRODUCTS = [
    ("wireless noise cancelling headphones", {"category": "audio", "price": 299.0}),
    ("bluetooth portable speaker waterproof", {"category": "audio", "price": 79.0}),
    ("mechanical keyboard rgb backlit", {"category": "peripherals", "price": 129.0}),
    ("ergonomic wireless mouse", {"category": "peripherals", "price": 49.0}),
    ("usb c charging cable fast", {"category": "accessories", "price": 12.0}),
    ("laptop stand aluminum adjustable", {"category": "accessories", "price": 39.0}),
    ("4k webcam autofocus streaming", {"category": "video", "price": 149.0}),
    ("studio condenser microphone podcast", {"category": "audio", "price": 99.0}),
]


def fake_embedding(text: str) -> np.ndarray:
    """Deterministic stand-in for a real text-embedding model."""
    h = abs(hash(text)) % (2**31)
    return np.random.default_rng(h).normal(size=DIM).astype(np.float32)


def main():
    # ---- in-memory hybrid index -------------------------------------------
    hybrid = new_hybrid_search_index(
        FlatIndex(DIM, DistanceKind.COSINE),
        BM25SearchIndex(),
        RoaringMetadataIndex(),
    )
    for text, meta in PRODUCTS:
        hybrid.add(fake_embedding(text), text, meta)

    query = "wireless audio headphones"
    hits = (
        hybrid.new_search()
        .with_vector(fake_embedding(query))
        .with_text(query)
        .with_metadata(eq("category", "audio"), lte("price", 300))
        .with_fusion_kind(FusionKind.RECIPROCAL_RANK)
        .with_k(3)
        .execute()
    )
    print(f"query: {query!r} (audio, <= $300)")
    for h in hits:
        text, meta = PRODUCTS[h.id - 1]
        print(f"  #{h.id} score={h.score:.4f}  {text}  ${meta['price']}")

    print("\nindex stats:", hybrid.stats()["docs"], "docs")

    # ---- durable storage ---------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        store = open_persistent_hybrid_index(StorageConfig(
            base_dir=os.path.join(tmp, "shop"),
            vector_index_factory=lambda: FlatIndex(DIM, DistanceKind.COSINE),
            text_index_factory=BM25SearchIndex,
            metadata_index_factory=RoaringMetadataIndex,
        ))
        by_id = {}
        for text, meta in PRODUCTS:
            by_id[store.add(fake_embedding(text), text, meta)] = (text, meta)
        store.flush()
        print("\nstorage stats:", store.stats())

        hits = (
            store.new_search()
            .with_text("keyboard mouse")
            .with_metadata(gte("price", 40))
            .with_k(3)
            .execute()
        )
        print("durable search 'keyboard mouse' (>= $40):")
        for h in hits:
            text, meta = by_id[h.id]
            print(f"  #{h.id} score={h.score:.4f}  {text}")
        store.close()


if __name__ == "__main__":
    main()
