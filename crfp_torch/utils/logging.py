"""Experiment directory, logging and the metrics stream
(crfp_tpu/utils/logging.py).

- ``mk_exp_dir``: creates save_dir, refuses to reuse an existing one unless
  ``--reset``, writes every flag to args.txt, and returns the run's logger.
- ``Logger``: file + console logging with the reference's format.
- ``MetricsWriter``: JSONL stream of scalar metrics per phase, the local
  replacement for the reference's visdom server.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time


class Logger:
    def __init__(self, log_file_name: str, logger_name: str = "MRCF", level=logging.INFO):
        self._logger = logging.getLogger(logger_name)
        self._logger.setLevel(level)
        for h in list(self._logger.handlers):
            self._logger.removeHandler(h)
            h.close()
        fmt = logging.Formatter("%(asctime)s - %(levelname)s: %(message)s")
        fh = logging.FileHandler(log_file_name)
        fh.setFormatter(fmt)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        self._logger.addHandler(fh)
        self._logger.addHandler(sh)

    def get_log(self) -> logging.Logger:
        return self._logger


def mk_exp_dir(args) -> logging.Logger:
    if os.path.exists(args.save_dir):
        if not args.reset:
            raise SystemExit(
                "Error: save_dir \"" + args.save_dir + "\" already exists! "
                "Please set --reset true to delete the folder."
            )
        shutil.rmtree(args.save_dir)
    os.makedirs(args.save_dir)
    os.makedirs(os.path.join(args.save_dir, "model"))

    with open(os.path.join(args.save_dir, "args.txt"), "w") as f:
        for k, v in sorted(vars(args).items()):
            f.write(f"{k}: {v}\n")

    return Logger(
        log_file_name=os.path.join(args.save_dir, args.log_file_name),
        logger_name=args.logger_name,
    ).get_log()


class MetricsWriter:
    """Append-only JSONL metrics stream: one record per scalar update."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)

    def write(self, phase: str, step: int, **scalars) -> None:
        rec = {"time": time.time(), "phase": phase, "step": step}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
