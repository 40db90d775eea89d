"""Copy of photon_tpu/utils/io_utils.py, lines 29-172 (framework-free; the port does not import it).

Driver I/O utilities: date-range input resolution, output-dir lifecycle and
text read/write.

Parity targets (reference photon-client):
- ``DateRange`` / ``DaysRange`` (util/DateRange.scala, util/DaysRange.scala):
  "yyyyMMdd-yyyyMMdd" date ranges and "start-end" days-ago ranges used to
  select daily input directories.
- ``IOUtils`` (util/IOUtils.scala): resolve input paths within a date range
  (daily-partitioned ``<base>/daily/yyyy/MM/dd`` layout), output-dir
  lifecycle (fail or delete when present), text file read/write.
"""


from __future__ import annotations

import dataclasses
import datetime as _dt
import logging
import os
import shutil
from typing import List, Optional, Sequence

_DATE_PATTERN = "%Y%m%d"
_DELIM = "-"


@dataclasses.dataclass(frozen=True)
class DateRange:
    """Inclusive [start, end] date range (reference DateRange.scala)."""

    start: _dt.date
    end: _dt.date

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(
                f"Invalid range: start date {self.start} comes after end date {self.end}"
            )

    @staticmethod
    def parse(spec: str) -> "DateRange":
        """Parse "yyyyMMdd-yyyyMMdd"."""
        try:
            start_s, end_s = spec.split(_DELIM)
            start = _dt.datetime.strptime(start_s, _DATE_PATTERN).date()
            end = _dt.datetime.strptime(end_s, _DATE_PATTERN).date()
        except ValueError as e:
            raise ValueError(f"Couldn't parse the date range: {spec}") from e
        return DateRange(start, end)

    def dates(self) -> List[_dt.date]:
        n = (self.end - self.start).days + 1
        return [self.start + _dt.timedelta(days=i) for i in range(n)]

    def __str__(self) -> str:
        return (
            f"{self.start.strftime(_DATE_PATTERN)}{_DELIM}"
            f"{self.end.strftime(_DATE_PATTERN)}"
        )


@dataclasses.dataclass(frozen=True)
class DaysRange:
    """"start-end" days-ago range, resolved against today
    (reference DaysRange.scala). start must be further back than end."""

    start_days_ago: int
    end_days_ago: int

    def __post_init__(self):
        if self.start_days_ago < self.end_days_ago:
            raise ValueError(
                f"Invalid range: start {self.start_days_ago} days ago is more "
                f"recent than end {self.end_days_ago} days ago"
            )
        if self.end_days_ago < 0:
            raise ValueError("days-ago values must be non-negative")

    @staticmethod
    def parse(spec: str) -> "DaysRange":
        try:
            start_s, end_s = spec.split(_DELIM)
            start, end = int(start_s), int(end_s)
        except ValueError as e:
            raise ValueError(f"Couldn't parse the days range: {spec}") from e
        return DaysRange(start, end)

    def to_date_range(self, today: Optional[_dt.date] = None) -> DateRange:
        today = today or _dt.date.today()
        return DateRange(
            today - _dt.timedelta(days=self.start_days_ago),
            today - _dt.timedelta(days=self.end_days_ago),
        )


def resolve_range_paths(
    base_dirs: Sequence[str],
    date_range: Optional[DateRange],
    errors_on_missing: bool = True,
) -> List[str]:
    """Expand base input dirs to daily subdirs within the date range.

    Layout: ``<base>/daily/yyyy/MM/dd`` (reference IOUtils.getInputPathsWithinDateRange).
    Without a range, returns the base dirs unchanged.
    """
    if date_range is None:
        return list(base_dirs)
    out: List[str] = []
    missing: List[str] = []
    for base in base_dirs:
        daily = os.path.join(base, "daily")
        root = daily if os.path.isdir(daily) else base
        for d in date_range.dates():
            p = os.path.join(root, f"{d.year:04d}", f"{d.month:02d}", f"{d.day:02d}")
            if os.path.isdir(p):
                out.append(p)
            else:
                missing.append(p)
    if not out and errors_on_missing:
        raise FileNotFoundError(
            f"No input found in {list(base_dirs)} for date range {date_range}"
        )
    if missing:
        # Days absent inside the range are skipped (reference
        # IOUtils.getInputPathsWithinDateRange keeps only existing paths) but
        # loudly: a silent gap means silently training on partial data.
        logging.getLogger(__name__).warning(
            "Date range %s: %d day dir(s) missing and skipped: %s",
            date_range, len(missing), ", ".join(missing[:5]) + ("..." if len(missing) > 5 else ""),
        )
    return out


def process_output_dir(output_dir: str, override: bool) -> None:
    """Output-dir lifecycle (reference IOUtils.processOutputDir,
    Driver.scala:154): fail if it exists non-empty unless override, in which
    case it is deleted first."""
    if os.path.exists(output_dir) and os.listdir(output_dir):
        if not override:
            raise FileExistsError(
                f"Output directory {output_dir} already exists (pass override to replace)"
            )
        shutil.rmtree(output_dir)
    os.makedirs(output_dir, exist_ok=True)


def date_range_from_specs(
    date_range_spec: Optional[str], days_range_spec: Optional[str],
) -> Optional[DateRange]:
    """Resolve the --input-data-date-range / --input-data-days-range pair
    (date range wins, matching GameDriver's precedence)."""
    if date_range_spec:
        return DateRange.parse(date_range_spec)
    if days_range_spec:
        return DaysRange.parse(days_range_spec).to_date_range()
    return None


def write_text(path: str, lines: Sequence[str]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for line in lines:
            f.write(line)
            f.write("\n")


def read_text(path: str) -> List[str]:
    with open(path) as f:
        return [line.rstrip("\n") for line in f]
