"""Feature indexing driver (port of photon_tpu/cli/feature_indexing.py):
scan the feature bags of Avro data and write one JSON index map per feature
shard, ``index-map-<shard>.json``, with ``feature-indexing-summary.json``
(shard → size), for ``game_training --feature-index-dir``.

    python -m photon_tpu_torch.cli.feature_indexing --input-paths train/ \\
        --output-dir idx/ --feature-shard-configurations name=globalShard

With ``--num-partitions N > 0`` each shard's map is written as the
partitioned native mmap store ``index-store-<shard>/`` instead
(data/native_index.py; its files are byte for byte the reference's).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

from photon_tpu_torch.cli.common import parse_feature_shard_config, setup_logging
from photon_tpu_torch.io.data_reader import build_index_maps, read_avro_rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("feature-indexing")
    p.add_argument("--input-paths", nargs="+", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-shard-configurations", nargs="+", default=["name=global"])
    p.add_argument("--num-partitions", type=int, default=0,
                   help=">0 writes the partitioned native mmap store instead of JSON")
    p.add_argument("--verbose", action="store_true")
    return p


def run(args) -> Dict[str, int]:
    setup_logging(args.verbose)
    shard_configs: Dict = {}
    for spec in args.feature_shard_configurations:
        shard_configs.update(parse_feature_shard_config(spec))
    index_maps = build_index_maps(read_avro_rows(args.input_paths), shard_configs)
    os.makedirs(args.output_dir, exist_ok=True)
    for shard, imap in index_maps.items():
        if args.num_partitions > 0:
            from photon_tpu_torch.data.native_index import NativeIndexMapBuilder

            NativeIndexMapBuilder(os.path.join(args.output_dir, f"index-store-{shard}"),
                                  args.num_partitions).build(imap)
        else:
            imap.save(os.path.join(args.output_dir, f"index-map-{shard}.json"))
    out = {shard: len(imap) for shard, imap in index_maps.items()}
    with open(os.path.join(args.output_dir, "feature-indexing-summary.json"), "w") as f:
        json.dump(out, f)
    return out


def main(argv=None) -> Dict[str, int]:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
