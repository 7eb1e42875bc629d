"""DAVIS 2016/2017 semi-supervised scoring over saved PNG results
(counterpart of `sam_pt_tpu/vos_eval/davis2017eval.py`, without pandas or
Pillow: tables are plain dicts of columns, CSVs go through `csv`, PNGs
through the port's codec).

Native re-implementation of the scoring flow the reference delegates to the
external `davis2017` package (sam_pt/vos_eval/davis2017eval.py:27-128):
per-sequence, per-object J (region) and F (boundary) over frames [1, T-1)
(first frame is the given GT, last is excluded per DAVIS protocol), global +
per-sequence tables, CSV caching, runnable as a CLI against a results folder.
"""
from __future__ import annotations

import csv
import math
import os
import re
from os import path
from typing import Dict, List, Tuple

import numpy as np

from .data.image_io import read_index_mask
from .metrics import db_eval_boundary, db_eval_iou, db_statistics

# A table: column name -> values, in column order (one row per index).
Table = Dict[str, list]


def _load_index_masks(dir_path: str, frames: List[str]) -> np.ndarray:
    out = []
    for f in frames:
        out.append(read_index_mask(path.join(dir_path, f))[0])
    return np.stack(out)


def _csv_value(value) -> str:
    """As pandas' `to_csv` writes a cell: floats by their shortest repr,
    NaN as an empty cell."""
    if isinstance(value, (float, np.floating)):
        return "" if math.isnan(value) else repr(float(value))
    return str(value)


def _parse_cell(text: str):
    """As `pandas.read_csv` reads a cell of these tables: numbers as
    float, an empty cell as NaN, anything else as text."""
    if text == "":
        return float("nan")
    try:
        return float(text)
    except ValueError:
        return text


def write_csv(table: Table, file: str) -> None:
    with open(file, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(list(table))
        for row in zip(*table.values()):
            writer.writerow([_csv_value(v) for v in row])


def read_csv(file: str) -> Table:
    with open(file, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: [_parse_cell(r[i]) for r in body]
            for i, name in enumerate(header)}


_FIXED = re.compile(r"^\s*[+-]?[0-9]+\.[0-9]*$")


def _float_cells(values) -> List[str]:
    """A float column as pandas prints it: six decimals, trailing zeros
    trimmed while every number has one (one digit kept after the point);
    scientific where a value would print as 0 or a long one passes 1e6."""
    def fmt(spec):
        return ["NaN" if math.isnan(v) else format(float(v), spec)
                for v in values]

    cells = fmt(".6f")
    while (any(_FIXED.match(c) for c in cells)
           and all(c.endswith("0") for c in cells if _FIXED.match(c))):
        cells = [c[:-1] if _FIXED.match(c) else c for c in cells]
    cells = [c + "0" if c.endswith(".") else c for c in cells]
    finite = [abs(v) for v in values if not math.isnan(v)]
    long = max(map(len, cells)) > 12
    if any(0 < a < 1e-6 for a in finite) or (
            long and any(a > 1e6 for a in finite)):
        cells = fmt(".6e")
    return cells


def format_table(table: Table) -> str:
    """The table as pandas' `to_string(index=False)` prints it: columns
    right-aligned one space apart, a numeric column one wider than its
    name."""
    columns = []
    for name, values in table.items():
        if all(isinstance(v, str) for v in values):
            cells, pad = list(values), 0
        elif all(isinstance(v, (int, np.integer)) for v in values):
            cells, pad = [str(v) for v in values], 1
        else:
            cells, pad = _float_cells(values), 1
        width = max([len(name) + pad] + [len(c) for c in cells])
        columns.append([c.rjust(width) for c in [name] + cells])
    return "\n".join(" ".join(row) for row in zip(*columns))


class Davis2017Evaluator:
    def __init__(
        self,
        results_path: str,
        davis_path: str,
        set: str = "val",
        task: str = "semi-supervised",
        year: str = "2017",
        sequences="all",
    ):
        if task != "semi-supervised":
            raise NotImplementedError(
                f"task={task!r}: only the semi-supervised DAVIS protocol is "
                "implemented (first/last frame excluded, per-first-frame "
                "object ids)"
            )
        self.results_path = results_path
        self.davis_path = davis_path
        self.set = set
        self.task = task
        self.year = year
        self.sequences = sequences

    def _sequence_list(self) -> List[str]:
        if self.sequences != "all":
            return list(self.sequences)
        imset = path.join(
            self.davis_path, "ImageSets", self.year, f"{self.set}.txt"
        )
        with open(imset) as f:
            return sorted(l.strip() for l in f if l.strip())

    def _evaluate_sequence(self, seq: str):
        gt_dir = path.join(self.davis_path, "Annotations", "480p", seq)
        res_dir = path.join(self.results_path, seq)
        frames = sorted(f for f in os.listdir(gt_dir) if f.endswith(".png"))
        gt = _load_index_masks(gt_dir, frames)  # [T, H, W]
        res = _load_index_masks(res_dir, frames)
        if self.year == "2016":
            gt = (gt > 0).astype(np.uint8)
            res = (res > 0).astype(np.uint8)

        object_ids = np.unique(gt[0])
        object_ids = object_ids[object_ids != 0]

        # semi-supervised protocol: exclude first (given) and last frames
        gt_eval = gt[1:-1]
        res_eval = res[1:-1]

        j_per_obj, f_per_obj = {}, {}
        for oid in object_ids:
            gt_o = gt_eval == oid
            res_o = res_eval == oid
            j_per_obj[int(oid)] = db_eval_iou(gt_o, res_o)
            f_per_obj[int(oid)] = db_eval_boundary(gt_o, res_o)
        return j_per_obj, f_per_obj

    def evaluate(self) -> Tuple[Table, Table]:
        """(global table, per-sequence table): one row of J&F, J and F
        statistics; one row per object with its J and F means."""
        csv_g = path.join(self.results_path, f"global_results-{self.set}.csv")
        csv_s = path.join(
            self.results_path, f"per-sequence_results-{self.set}.csv"
        )
        if path.exists(csv_g) and path.exists(csv_s):
            print(f"Using pre-computed results from {csv_g}")
            return read_csv(csv_g), read_csv(csv_s)

        seq_names, j_means, f_means = [], [], []
        j_all, f_all = [], []  # per-object statistics triples
        for seq in self._sequence_list():
            j_per_obj, f_per_obj = self._evaluate_sequence(seq)
            for oid in j_per_obj:
                jm, jr, jd = db_statistics(j_per_obj[oid])
                fm, fr, fd = db_statistics(f_per_obj[oid])
                j_all.append((jm, jr, jd))
                f_all.append((fm, fr, fd))
                seq_names.append(f"{seq}_{oid}")
                j_means.append(jm)
                f_means.append(fm)

        if not j_all:
            raise ValueError(
                f"no sequences/objects to score under {self.results_path!r} "
                f"(sequences={self.sequences!r}) — nothing was evaluated"
            )
        j_arr = np.array(j_all)
        f_arr = np.array(f_all)
        g = {
            "J&F-Mean": [(j_arr[:, 0].mean() + f_arr[:, 0].mean()) / 2],
            "J-Mean": [j_arr[:, 0].mean()],
            "J-Recall": [j_arr[:, 1].mean()],
            "J-Decay": [j_arr[:, 2].mean()],
            "F-Mean": [f_arr[:, 0].mean()],
            "F-Recall": [f_arr[:, 1].mean()],
            "F-Decay": [f_arr[:, 2].mean()],
        }
        df_global = {k: [float(x) for x in v] for k, v in g.items()}
        df_seq = {"Sequence": seq_names, "J-Mean": j_means, "F-Mean": f_means}
        try:
            write_csv(df_global, csv_g)
            write_csv(df_seq, csv_s)
        except OSError:
            pass
        print(format_table(df_global))
        return df_global, df_seq


def main():
    import argparse

    ap = argparse.ArgumentParser(description="Score saved VOS PNGs on DAVIS")
    ap.add_argument("--results_path", required=True)
    ap.add_argument("--davis_path", required=True)
    ap.add_argument("--set", default="val")
    ap.add_argument("--task", default="semi-supervised")
    ap.add_argument("--year", default="2017")
    args = ap.parse_args()
    Davis2017Evaluator(
        results_path=args.results_path,
        davis_path=args.davis_path,
        set=args.set,
        task=args.task,
        year=args.year,
    ).evaluate()


if __name__ == "__main__":
    main()
