"""Meters and logging sinks.

Counterpart of ``localregneuralde_tpu/harness/logging.py`` (reference
``experiments/src/logging.jl``): running meters, a flushed CSV sink per
run and split, and the column sets of the reference. NFE is a first-class
column. The Weights & Biases sink is a no-op here.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence


class AverageMeter:
    """Running value, sum, count and average (reference
    ``logging.jl:2-34``)."""

    def __init__(self, name: str, fmt: str = "{:.4f}"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.average = 0.0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.average = self.sum / max(self.count, 1)
        return self.average

    def __str__(self):
        return (f"{self.name} {self.fmt.format(self.val)} "
                f"({self.fmt.format(self.average)})")


class CSVLogger:
    """Header and one flushed row per call (reference ``logging.jl:65-85``)."""

    def __init__(self, path: str, header: Sequence[str]):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.header = list(header)
        self._fh = open(path, "w", newline="")
        self._writer = csv.writer(self._fh)
        self._writer.writerow(self.header)
        self._fh.flush()

    def log(self, row: Sequence):
        self._writer.writerow([_scalar(v) for v in row])
        self._fh.flush()

    def close(self):
        self._fh.close()


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class WandbLogger:
    """The Weights & Biases sink of the reference, as a no-op: the port
    logs to CSV and the console only."""

    def __init__(self, project: str = "", name: str = "",
                 config: Optional[Dict] = None):
        pass

    def log(self, values: Dict, step: Optional[int] = None):
        pass


def create_logger(log_dir: str, total_steps: int, *, latent_ode: bool = False,
                  sde: bool = False, expt_name: str = "run",
                  config: Optional[Dict] = None):
    """The meters and sinks of a run, with the reference's column sets
    (``logging.jl:87-190``): NFE, or the drift and diffusion NFE; CE, or
    NLL and KL; accuracy for classification only."""
    if latent_ode:
        loss_cols = ["neg_log_likelihood", "kl_div", "reg_val", "net_loss"]
    else:
        loss_cols = ["ce_loss", "reg_val", "net_loss"]
    nfe_cols = ["nfe_drift", "nfe_diffusion"] if sde else ["nfe"]
    acc_cols = [] if latent_ode else ["accuracy_top1", "accuracy_top5"]
    time_cols = ["batch_time", "data_time", "fwd_time", "bwd_time",
                 "opt_time", "step_time"]
    train_header = ["step"] + time_cols + loss_cols + nfe_cols + acc_cols
    eval_header = ["step"] + loss_cols + nfe_cols + acc_cols
    return {
        "train_meters": {name: AverageMeter(name)
                         for name in time_cols + loss_cols + nfe_cols + acc_cols},
        "eval_meters": {name: AverageMeter(name)
                        for name in loss_cols + nfe_cols + acc_cols},
        "csv_train": CSVLogger(os.path.join(log_dir, "results_train.csv"),
                               train_header),
        "csv_eval": CSVLogger(os.path.join(log_dir, "results_eval.csv"),
                              eval_header),
        "wandb": WandbLogger(expt_name, expt_name, config),
        "train_header": train_header,
        "eval_header": eval_header,
    }


def get_loggable_values(meters: Dict[str, AverageMeter], header: List[str],
                        step: int) -> List:
    row = [step]
    for name in header[1:]:
        row.append(meters[name].average if name in meters else float("nan"))
    return row


def reset_meters(meters: Dict[str, AverageMeter]):
    for m in meters.values():
        m.reset()
