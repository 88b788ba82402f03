"""Roofline analysis: three terms per (arch x shape x mesh) on the H100.
Reference: ``benchmarks/roofline.py`` (``_analytic``, :38; ``wire_bytes``,
:62; ``analyze_cell``, :70; ``what_would_help``, :99; ``load_rows``,
``markdown_table``, ``run``).

Reads the port's dry-run records (``repro_torch.launch.dryrun``, by default
``build/dryrun_torch/*.json``) and combines:

  compute term    = analytic flops / (chips x 989 TFLOP/s bf16)
  memory term     = analytic HBM bytes / (chips x 3.35 TB/s)
  collective term = recorded wire bytes / the card's NVLink bytes/s

The flops and bytes are ``repro_torch.analysis.perfmodel``'s; the constants
are one H100 SXM's (NVIDIA's data sheet, dense rates at 700 W) and its
NVLink as ``nvidia-smi nvlink --status`` reports it on an NVIDIA H100
80GB HBM3 (``NVLINK_BW``: links x rate per link, one direction). The
reference's are v5e's 197 TFLOP/s, 819 GB/s and a 50 GB/s ICI link;
``analyze_cell`` takes them as arguments, so the reference's numbers
come back from its own constants.

Two deliberate differences from the reference:
  * ``model_shard`` is the cell's own M (``mesh_model``); the reference
    hard-codes 16 (:50).
  * The reference counts every train cell at remat ``'full'``; that is the
    port's count for its ``'dots'`` too, which recomputes the whole layer
    (ROADMAP Queue 3, "Remat ``dots`` under ``torch.func``").
    ``perfmodel`` itself is the reference's, bit for bit.

``step_shares`` turns a measured step time into the step's shares of the
card: ``mfu = model_flops / (measured_s x chips x peak)`` and, for a decode
step, ``hbm_share`` (the step's HBM bytes over the time at 3.35 TB/s). A
share over 1.0 means a count is wrong, and it raises.

    python -m repro_torch.benchmarks.roofline [--dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import configs
from repro_torch.analysis import perfmodel
from repro_torch.configs.base import SHAPES_BY_NAME

PEAK_FLOPS = 989e12          # bf16 dense / card (H100 SXM)
HBM_BW = 3.35e12             # bytes/s / card
# NVLink bytes/s a card, one direction: 18 links x 26.562 GB/s
# (``nvidia-smi nvlink --status`` on an NVIDIA H100 80GB HBM3, 700.00 W)
NVLINK_BW = 18 * 26.562e9

WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "build", "dryrun_torch")


def analytic(cfg, shape, *, chips: int, model_shard: int,
             zero1: bool = True) -> Tuple[float, float, float]:
    """(flops, hbm_bytes, model_flops) global per step of ``cfg`` on
    ``shape`` (a train, prefill or decode shape)."""
    remat = "full" if shape.kind == "train" else "none"
    f = perfmodel.cell_flops(cfg, shape, remat=remat)
    b = perfmodel.cell_bytes(cfg, shape, chips=chips, model_shard=model_shard,
                             zero1=zero1, remat=remat)
    if shape.kind == "train":
        return f.train, b.train, f.model_flops_train
    if shape.kind == "prefill":
        return f.fwd, b.fwd, f.model_flops_fwd
    t = shape.global_batch * 1
    n_active = perfmodel._param_count(cfg, active_only=True)
    return f.decode, b.decode, 2.0 * n_active * t


def _analytic(cell: Dict[str, Any], model_shard: Optional[int] = None
              ) -> Tuple[float, float, float]:
    """(flops, hbm_bytes, model_flops) global per step for this cell."""
    cfg = configs.get_config(cell["arch"])
    shape = SHAPES_BY_NAME[cell["shape"]]
    policy = cell.get("policy", {})
    return analytic(cfg, shape, chips=cell["devices"],
                    model_shard=(cell.get("mesh_model", 1)
                                 if model_shard is None else model_shard),
                    zero1=policy.get("zero1", True))


def wire_bytes(coll: Dict[str, Any]) -> float:
    total = 0.0
    for kind, d in coll.get("per_kind", {}).items():
        payload = d.get("wire_bytes", d.get("bytes", 0.0))
        total += WIRE_FACTOR.get(kind, 1.0) * payload
    return total


def analyze_cell(cell: Dict[str, Any], *, peak_flops: float = PEAK_FLOPS,
                 hbm_bw: float = HBM_BW, link_bw: float = NVLINK_BW,
                 model_shard: Optional[int] = None
                 ) -> Optional[Dict[str, Any]]:
    """The roofline row of one ``ok`` record (None otherwise). The
    constants default to the card's; ``model_shard`` to the cell's M."""
    if cell.get("status") != "ok":
        return None
    chips = cell["devices"]
    flops, hbm, model_flops = _analytic(cell, model_shard)
    t_compute = flops / (chips * peak_flops)
    t_memory = hbm / (chips * hbm_bw)
    t_coll = wire_bytes(cell["collectives"]) / link_bw   # already per card
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    t_bound = terms[dominant]
    t_ideal = model_flops / (chips * peak_flops)
    mem = cell.get("memory", {})
    per_dev_gb = ((mem.get("argument_bytes") or 0)
                  + (mem.get("temp_bytes") or 0)) / 1e9
    return {
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "tag": cell.get("tag", ""), "chips": chips,
        "compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll,
        "dominant": dominant, "bound_s": t_bound,
        "model_flops": model_flops, "hlo_flops_analytic": flops,
        "hlo_flops_raw_undercounted": cell.get("cost", {}).get("flops"),
        "useful_flops_ratio": model_flops / max(flops, 1.0),
        "roofline_fraction": t_ideal / max(t_bound, 1e-30),
        "mem_gb_per_device": per_dev_gb,
        "policy": cell.get("policy", {}),
    }


def step_shares(cfg, shape, measured_s: float, *, chips: int = 1,
                model_shard: int = 1, peak_flops: float = PEAK_FLOPS,
                hbm_bw: float = HBM_BW) -> Dict[str, float]:
    """A measured step's shares of ``chips`` cards: ``mfu`` (useful model
    flops over the time at the bf16 peak), beside the roofline terms of
    the step and, for a decode shape, ``hbm_share`` (its HBM bytes over
    the time at the HBM rate). Raises when a share exceeds 1."""
    if not measured_s > 0:
        raise ValueError(f"measured time must be positive, got {measured_s}")
    flops, hbm, model_flops = analytic(cfg, shape, chips=chips,
                                       model_shard=model_shard)
    out = {"measured_s": measured_s, "model_flops": model_flops,
           "flops": flops, "hbm_bytes": hbm,
           "compute_s": flops / (chips * peak_flops),
           "memory_s": hbm / (chips * hbm_bw),
           "mfu": model_flops / (measured_s * chips * peak_flops)}
    if shape.kind == "decode":
        out["hbm_share"] = hbm / (measured_s * chips * hbm_bw)
    for k in ("mfu", "hbm_share"):
        if out.get(k, 0.0) > 1.0:
            raise ValueError(f"{k} {out[k]:.4g} > 1: the step cannot beat "
                             f"the card's peak; a count is wrong")
    return out


def what_would_help(row: Dict[str, Any]) -> str:
    d = row["dominant"]
    if d == "collective":
        return ("cut wire bytes: bf16 or int8_ef gradients "
                "(distributed.compression), fewer tensor-parallel "
                "all-reduces (sequence parallelism)")
    if d == "memory":
        return ("cut HBM traffic: larger per-worker batches (amortize "
                "parameter reads), fuse the optimizer and EMA, quantize "
                "cache/params")
    return ("raise tensor-core use: bigger per-card tiles, less remat "
            "recompute, fused attention (the flash kernel)")


def load_rows(tag: str = "", directory: str = DRYRUN_DIR
              ) -> List[Dict[str, Any]]:
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            cell = json.load(f)
        if cell.get("tag", "") != tag:
            continue
        r = analyze_cell(cell)
        if r:
            rows.append(r)
    return rows


def markdown_table(rows: List[Dict[str, Any]], mesh: str = "1x1") -> str:
    lines = ["| arch | shape | comp s | mem s | coll s | dominant | "
             "roofline frac | useful ratio | GB/dev |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"{r['dominant']} | {r['roofline_fraction']:.2f} | "
            f"{r['useful_flops_ratio']:.2f} | {r['mem_gb_per_device']:.1f} |")
    return "\n".join(lines)


def run(quick: bool = True, directory: str = DRYRUN_DIR
        ) -> List[Tuple[str, float, str]]:
    """The reference's rows (it also saves them as JSON; this prints)."""
    rows = load_rows(directory=directory)
    if not rows:
        return [("roofline.cells", 0.0, "no dryrun results found")]
    out = [("roofline.cells", 0.0, str(len(rows)))]
    worst = sorted((r for r in rows if r["mesh"] == "1x1"),
                   key=lambda r: r["roofline_fraction"])
    for r in worst[:3]:
        out.append((f"roofline.worst.{r['arch']}.{r['shape']}", 0.0,
                    f"frac={r['roofline_fraction']:.2f},dom={r['dominant']}"))
    coll_bound = [r for r in rows if r["dominant"] == "collective"
                  and r["mesh"] == "1x1"]
    out.append(("roofline.collective_bound_cells", 0.0, str(len(coll_bound))))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=DRYRUN_DIR)
    args = ap.parse_args()
    rows = load_rows(directory=args.dir)
    for mesh in sorted({r["mesh"] for r in rows}):
        print(f"mesh {mesh}")
        print(markdown_table(rows, mesh))
        print()
