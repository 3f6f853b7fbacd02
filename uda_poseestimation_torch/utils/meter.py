"""Progress meters with the reference's exact print formats.

The port's copy of ``uda_poseestimation_tpu/utils/meter.py`` (reference
lib/meter.py): the trainers print tab-joined
``Epoch: [e][  i/500] Time ... Data ... Loss (all) ...`` lines and the
validators aggregate per-keypoint accuracy with ignore_val=-1, character
for character as the JAX package does, so log parsers built for either keep
working.
"""

from __future__ import annotations

from typing import List, Optional


class AverageMeter:
    """Running value/average pair, skipping ``ignore_val`` updates."""

    def __init__(self, name: str, fmt: Optional[str] = ":f", ignore_val=None):
        self.name = name
        self.fmt = fmt
        self.ignore_val = ignore_val
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n: int = 1):
        if val != self.ignore_val:
            self.val = val
            self.sum += val * n
            self.count += n
            if self.count > 0:
                self.avg = self.sum / self.count

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class AverageMeterList:
    """One AverageMeter per entry of a list (per-keypoint accuracy)."""

    def __init__(self, names: List, fmt: Optional[str] = ":f", ignore_val=None):
        self.list = [AverageMeter(name, fmt, ignore_val) for name in names]

    def reset(self):
        for meter in self.list:
            meter.reset()

    def update(self, accuracies, n: int = 1):
        for ind, acc in enumerate(accuracies):
            self.list[ind].update(acc, n)

    def average(self):
        return [meter.avg for meter in self.list]

    def __getitem__(self, item):
        return self.list[item]


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.batch_fmtstr = self._get_batch_fmtstr(num_batches)
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(meter) for meter in self.meters]
        print("\t".join(entries))

    @staticmethod
    def _get_batch_fmtstr(num_batches: int):
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"
