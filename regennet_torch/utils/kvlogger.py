"""Key-value training logger (the port's copy of
regennet_tpu/utils/kvlogger.py).

The surface the training loop uses (logkv / logkv_mean / dumpkvs / log)
with human-readable stdout, CSV, JSON-lines and TensorBoard writers
(the last under {log_dir}/tb). State is a module-level current logger.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, Optional


class KVWriter:
    def writekvs(self, kvs: Dict):
        raise NotImplementedError


class HumanOutputFormat(KVWriter):
    def writekvs(self, kvs):
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[self._truncate(key)] = self._truncate(valstr)
        if not key2str:
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        # case-insensitive display order
        for key, val in sorted(key2str.items(), key=lambda kv: kv[0].lower()):
            lines.append(
                f"| {key}{' ' * (keywidth - len(key))} | "
                f"{val}{' ' * (valwidth - len(val))} |"
            )
        lines.append(dashes)
        print("\n".join(lines), flush=True)

    @staticmethod
    def _truncate(s, maxlen=30):
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s


class CSVOutputFormat(KVWriter):
    def __init__(self, filename):
        self.filename = filename
        self.keys = []

    def writekvs(self, kvs):
        extra_keys = sorted(set(kvs.keys()) - set(self.keys))
        rows = []
        if extra_keys:
            self.keys += extra_keys
            if os.path.exists(self.filename):
                with open(self.filename) as f:
                    rows = list(csv.reader(f))[1:]
        with open(self.filename, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(self.keys)
            for row in rows:
                w.writerow(row + [""] * (len(self.keys) - len(row)))
            w.writerow([kvs.get(k, "") for k in self.keys])


class JSONOutputFormat(KVWriter):
    """One JSON object per dump, one per line (progress.json)."""

    def __init__(self, filename):
        self.filename = filename

    def writekvs(self, kvs):
        import json

        out = {
            k: (float(v) if hasattr(v, "dtype") or isinstance(v, float)
                else v)
            for k, v in kvs.items()
        }
        with open(self.filename, "a") as f:
            f.write(json.dumps(out) + "\n")


class TensorBoardOutputFormat(KVWriter):
    """Scalar events per dump into {log_dir} (torch.utils.tensorboard's
    SummaryWriter, imported here), at the dump's "step" key, else one past
    the last."""

    def __init__(self, log_dir):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=log_dir)
        self.step = 0

    def writekvs(self, kvs):
        self.step = int(kvs.get("step", self.step + 1))
        for k, v in kvs.items():
            try:
                self.writer.add_scalar(k, float(v), self.step)
            except (TypeError, ValueError):
                continue
        self.writer.flush()


class Logger:
    def __init__(self, log_dir: Optional[str] = None, formats=("human", "csv")):
        self.name2val = defaultdict(float)
        self.name2cnt = defaultdict(int)
        self.writers = []
        self.log_dir = log_dir
        for fmt in formats:
            if fmt == "human":
                self.writers.append(HumanOutputFormat())
            elif fmt == "csv" and log_dir:
                os.makedirs(log_dir, exist_ok=True)
                self.writers.append(
                    CSVOutputFormat(os.path.join(log_dir, "progress.csv"))
                )
            elif fmt == "json" and log_dir:
                os.makedirs(log_dir, exist_ok=True)
                self.writers.append(
                    JSONOutputFormat(os.path.join(log_dir, "progress.json"))
                )
            elif fmt == "tensorboard" and log_dir:
                self.writers.append(
                    TensorBoardOutputFormat(os.path.join(log_dir, "tb"))
                )

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        out = dict(self.name2val)
        for w in self.writers:
            w.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()
        return out


_CURRENT: Optional[Logger] = None


def configure(log_dir: Optional[str] = None, formats=None):
    """formats default: human,csv; REGENNET_LOG_FORMAT overrides them (a
    comma list of human/csv/json/tensorboard)."""
    global _CURRENT
    if formats is None:
        formats = tuple(
            os.environ.get("REGENNET_LOG_FORMAT", "human,csv").split(",")
        )
    _CURRENT = Logger(log_dir, formats)
    return _CURRENT


def get_current() -> Logger:
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = Logger()
    return _CURRENT


def logkv(key, val):
    get_current().logkv(key, val)


def logkv_mean(key, val):
    get_current().logkv_mean(key, val)


def dumpkvs():
    return get_current().dumpkvs()


def log(*args):
    print(*args, flush=True)

