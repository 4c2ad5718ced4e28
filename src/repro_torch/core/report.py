"""Prediction-vs-ground-truth reporting (paper section 4)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GiB = 1024 ** 3


@dataclass
class PredictionRecord:
    label: str
    predicted_bytes: int
    actual_bytes: int

    @property
    def ape(self) -> float:
        """Absolute percentage error.  A record with no usable ground
        truth (``actual_bytes <= 0``) has no defined error — it returns
        NaN, never the 0.0 that once let a defective zero-measured record
        read as a PERFECT prediction and deflate every MAPE built on it.
        """
        if self.actual_bytes <= 0:
            return float("nan")
        return abs(self.predicted_bytes - self.actual_bytes) \
            / self.actual_bytes * 100.0


def split_valid(records: list[PredictionRecord]
                ) -> tuple[list[PredictionRecord], int]:
    """(records with usable ground truth, count excluded).  Zero/negative
    actuals are measurement defects: they are EXCLUDED from aggregate
    error arithmetic and reported as a count, never averaged in."""
    valid = [r for r in records if r.actual_bytes > 0]
    return valid, len(records) - len(valid)


def mape(records: list[PredictionRecord]) -> float:
    valid, _ = split_valid(records)
    if not valid:
        return 0.0
    return float(np.mean([r.ape for r in valid]))


def grouped_mape(groups: dict[str, list[PredictionRecord]]
                 ) -> list[tuple[str, int, float]]:
    """(group, n_valid, MAPE%) rows, sorted by group — the per-arch/
    per-family accuracy table the calibration reporter emits (paper
    section 4).  ``n_valid`` counts only records with usable ground
    truth (see :func:`split_valid`)."""
    out = []
    for k, v in sorted(groups.items()):
        valid, _ = split_valid(v)
        out.append((k, len(valid), mape(valid)))
    return out


def table(records: list[PredictionRecord], title: str = "") -> str:
    lines = []
    if title:
        lines.append(f"## {title}")
    lines.append(f"{'label':<40s} {'pred GiB':>10s} {'actual GiB':>11s} "
                 f"{'APE %':>7s}")
    for r in records:
        lines.append(f"{r.label:<40s} {r.predicted_bytes / GiB:>10.3f} "
                     f"{r.actual_bytes / GiB:>11.3f} {r.ape:>7.2f}")
    lines.append(f"{'MAPE':<40s} {'':>10s} {'':>11s} {mape(records):>7.2f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Generic table writers (used by core.sweep's report output).
# ---------------------------------------------------------------------------


def markdown_table(headers, rows, title: str = "") -> str:
    """GitHub-flavoured markdown table from header names + row tuples."""
    headers = [str(h) for h in headers]
    body = [[str(c) for c in r] for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in body)) if body else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "| " + " | ".join(c.ljust(w) for c, w in zip(cells, widths)) \
            + " |"
    out = []
    if title:
        out += [f"## {title}", ""]
    out.append(line(headers))
    out.append("|" + "|".join("-" * (w + 2) for w in widths) + "|")
    out.extend(line(r) for r in body)
    return "\n".join(out)


def csv_table(headers, rows) -> str:
    """CSV from header names + row tuples (no quoting — numeric/simple
    cells only, which is all the sweep emits)."""
    out = [",".join(str(h) for h in headers)]
    out.extend(",".join(str(c) for c in r) for r in rows)
    return "\n".join(out)


def csv(records: list[PredictionRecord]) -> str:
    out = ["label,predicted_bytes,actual_bytes,ape_pct"]
    for r in records:
        out.append(f"{r.label},{r.predicted_bytes},{r.actual_bytes},"
                   f"{r.ape:.3f}")
    out.append(f"MAPE,,,{mape(records):.3f}")
    return "\n".join(out)
