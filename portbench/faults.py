"""The faults a cell can have, planted in the plain reference put in the
program's place, so that each can be read at a cell's own size on the
card (``readings.py --faults``):

- ``state_unchanged``: every training step returns its state unchanged
  (the learning rate is 0, so U, V and the moments never move);
- ``half_batch``: each batch's second half is left out and the mean is
  taken over the rest;
- ``answer_altered``: one answer of every call is altered: its first
  run's test accuracy moved by one point (100 of the canonical run's
  10,000 test labels); in the oracle's entry, the first run's
  ground-truth accuracy moved by one test label;
- ``one_label``: every call's first test accuracy moved by one test
  label, the smallest alteration there is (read to show what
  ``result_gap`` cannot see at a cell's size; not a fault a cell has to
  catch).

A fault is planted in whatever reference the cell found (``spec.Cell``'s
``reference``), by a subclass made from it at run time, so a later
configuration's reference is read with no change here.  The cells run on
one card, so no exchange between cards can be left out; the oracle trains
nothing and can have only an altered answer.
"""

from __future__ import annotations

import torch

TRAINING = ("state_unchanged", "half_batch", "answer_altered")
ORACLE = ("answer_altered",)
READ_ONLY = ("one_label",)
POINT = 0.01


def _half_batch(trainer):
    """``trainer`` with each batch's second half left out."""

    class HalfBatch(trainer):
        def _load_epoch(self, epoch: int):
            z, mask, _ = super()._load_epoch(epoch)
            mask = mask.clone()
            mask[..., self.sh.batch_size // 2:] = 0.0
            inv = 1.0 / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
            self.zw.copy_(torch.stack([z, mask * inv.unsqueeze(-1)], dim=2))
            return z, mask, inv

    return HalfBatch


def planted(reference, fault: str):
    """A subclass of ``reference`` (a cell's reference class) with
    ``fault`` planted; built as ``planted(reference, fault)(device)``, in
    float32."""
    if fault not in TRAINING + READ_ONLY:
        raise ValueError(f"no fault {fault!r}; known: "
                         f"{TRAINING + READ_ONLY}")

    class Faulty(reference):
        @property
        def trainer(self):
            base = super().trainer
            return _half_batch(base) if fault == "half_batch" else base

        def train(self, U, V, train, val, epochs_key, lr, wd, sh):
            if fault == "state_unchanged":
                lr = torch.zeros_like(lr)
            return super().train(U, V, train, val, epochs_key, lr, wd, sh)

        def study_runs(self, seeds, config_indices, s, lr, wd, reps, sh):
            results = super().study_runs(seeds, config_indices, s, lr, wd,
                                         reps, sh)
            if fault in ("answer_altered", "one_label"):
                by = (POINT if fault == "answer_altered"
                      else 1.0 / self.test_labels(sh))
                # the first run of every call: repetition 0 of
                # configuration 0
                for res, idx in zip(results, config_indices):
                    if idx == 0:
                        res["accuracy"] = res["accuracy"].copy()
                        res["accuracy"][0] += by
            return results

        def oracle_runs(self, seeds, config_indices, s, reps, sh):
            loss, acc = super().oracle_runs(seeds, config_indices, s, reps,
                                            sh)
            if fault == "answer_altered":
                acc = acc.copy()
                for c, idx in enumerate(config_indices):
                    if idx == 0:
                        acc[c, 0] += 1.0 / self.test_labels(sh)
            return loss, acc

    Faulty.__name__ = Faulty.__qualname__ = f"{reference.__name__}.{fault}"
    return Faulty
