#!/usr/bin/env bash
# Fetch the real SIFT1M corpus (the dataset behind every reference baseline
# row, /root/reference/docs/INDEX.md:694-5342) and point the benchmark at it.
#
# It needs network access, so it documents the exact procedure for any
# environment that has it.
#
# Usage:
#   ./scripts/fetch_sift1m.sh /path/to/datasets
#   COMET_DATASET_DIR=/path/to/datasets/sift python bench.py --all
set -euo pipefail

DEST="${1:-./datasets}"
mkdir -p "$DEST"
cd "$DEST"

# ~161 MB tarball: sift_base.fvecs (1M x 128), sift_query.fvecs (10k x 128),
# sift_learn.fvecs (100k x 128), sift_groundtruth.ivecs (10k x 100)
URL="ftp://ftp.irisa.fr/local/texmex/corpus/sift.tar.gz"

if command -v curl >/dev/null; then
  curl -fO "$URL"
elif command -v wget >/dev/null; then
  wget "$URL"
else
  echo "need curl or wget" >&2
  exit 1
fi

tar -xzf sift.tar.gz
echo "SIFT1M ready: $(pwd)/sift"
echo "run: COMET_DATASET_DIR=$(pwd)/sift python bench.py --all"
