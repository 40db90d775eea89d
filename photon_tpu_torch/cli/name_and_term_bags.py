"""Name-and-term feature bags driver (copy of photon_tpu/cli/name_and_term_bags.py,
framework-free; the port does not import it): scan input data → distinct
feature (name, term) sets per feature bag, saved as text files.

    python -m photon_tpu_torch.cli.name_and_term_bags --input-data-directories train/ \\
        --root-output-directory bags/ --feature-bags-keys features userFeatures

Parity target: reference ``NameAndTermFeatureBagsDriver``
(photon-client data/avro/NameAndTermFeatureBagsDriver.scala:196) +
``NameAndTermFeatureMapUtils.saveNameAndTermsAsTextFiles`` /
``readNameAndTermFeatureMapFromTextFiles``
(data/avro/NameAndTermFeatureMapUtils.scala): one directory per feature bag
under the root output directory, containing ``name<TAB>term`` lines. These
text bags are the non-PalDB path for building feature index maps
(GameDriver.prepareFeatureMapsDefault, cli/game/GameDriver.scala:190-217).
"""

from __future__ import annotations

import argparse
import glob as globlib
import os
from typing import Dict, List, Sequence, Set, Tuple

from photon_tpu_torch.cli.common import setup_logging
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.io.data_reader import read_avro_rows
from photon_tpu_torch.utils.io_utils import (
    date_range_from_specs,
    process_output_dir,
    resolve_range_paths,
)

# Reference NameAndTerm.STRING_DELIMITER is "\t".
DELIMITER = "\t"


def save_name_and_terms(output_dir: str, bag: str,
                        name_terms: Set[Tuple[str, str]]) -> str:
    """Write one bag's distinct (name, term) set as text
    (NameAndTermFeatureMapUtils.saveAsTextFiles layout: <root>/<bag>/...)."""
    bag_dir = os.path.join(output_dir, bag)
    os.makedirs(bag_dir, exist_ok=True)
    path = os.path.join(bag_dir, "part-00000")
    with open(path, "w") as f:
        for name, term in sorted(name_terms):
            f.write(f"{name}{DELIMITER}{term}\n")
    return path


def load_name_and_terms(output_dir: str, bag: str) -> List[Tuple[str, str]]:
    """Read a bag's (name, term) set back
    (NameAndTermFeatureMapUtils.readNameAndTermRDDFromTextFiles)."""
    out: List[Tuple[str, str]] = []
    for path in sorted(globlib.glob(os.path.join(output_dir, bag, "part-*"))):
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split(DELIMITER)
                if len(parts) == 2:
                    out.append((parts[0], parts[1]))
                elif len(parts) == 1:
                    out.append((parts[0], ""))
                else:
                    raise ValueError(
                        f"Cannot parse name-and-term line {line!r} in {path}"
                    )
    return out


def index_map_from_text_bags(output_dir: str, bags: Sequence[str],
                             add_intercept: bool = True) -> IndexMap:
    """Build one feature IndexMap from the union of text bags
    (GameDriver.prepareFeatureMapsDefault role)."""
    keys = []
    for bag in bags:
        for name, term in load_name_and_terms(output_dir, bag):
            keys.append(IndexMap.key(name, term))
    return IndexMap.build(keys, add_intercept=add_intercept)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("name-and-term-feature-bags")
    p.add_argument("--input-data-directories", nargs="+", required=True)
    p.add_argument("--input-data-date-range", default=None,
                   help="yyyyMMdd-yyyyMMdd over daily-format input dirs")
    p.add_argument("--input-data-days-range", default=None,
                   help="start-end days ago over daily-format input dirs")
    p.add_argument("--root-output-directory", required=True)
    p.add_argument("--feature-bags-keys", nargs="+", required=True)
    p.add_argument("--override-output-directory", action="store_true")
    p.add_argument("--verbose", action="store_true")
    return p


def run(args) -> Dict[str, int]:
    setup_logging(args.verbose)
    date_range = date_range_from_specs(
        args.input_data_date_range, args.input_data_days_range
    )
    paths = resolve_range_paths(args.input_data_directories, date_range)
    process_output_dir(args.root_output_directory, args.override_output_directory)

    bag_sets: Dict[str, Set[Tuple[str, str]]] = {
        bag: set() for bag in args.feature_bags_keys
    }
    for row in read_avro_rows(paths):
        for bag, name_terms in bag_sets.items():
            for f in row.get(bag) or []:
                name_terms.add((f["name"], f.get("term") or ""))
    counts: Dict[str, int] = {}
    for bag, name_terms in bag_sets.items():
        save_name_and_terms(args.root_output_directory, bag, name_terms)
        counts[bag] = len(name_terms)
    return counts


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    counts = run(args)
    for bag, n in counts.items():
        print(f"{bag}: {n} distinct name-and-term features")


if __name__ == "__main__":
    main()
