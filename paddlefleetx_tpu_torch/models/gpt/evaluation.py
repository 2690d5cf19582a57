"""GPT zero-shot evaluation: perplexity over overlapping windows and
LAMBADA-style last-word accuracy.

Counterpart of ``paddlefleetx_tpu/models/gpt/evaluation.py``
(``LMEvalMetric:22``, ``GPTEvalModule:54``), driven by the
``LM_Eval_Dataset`` / ``Lambada_Eval_Dataset`` of ``data/gpt_dataset.py``
or any GPT dataset.  ``predict_fn`` gives one row per sequence, (masked
nll sum, mask count, all masked tokens argmax-correct); the metric adds
the rows up into the corpus perplexity and the sequence accuracy.
:meth:`GPTEvalModule.loss_and_predict` gives the batch's loss and its rows
from one forward, which is what ``Engine.evaluate`` runs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.models.gpt import model as gpt
from paddlefleetx_tpu_torch.models.metrics import METRICS, Metric


@METRICS.register("LMEval")
class LMEvalMetric(Metric):
    """Accumulates the masked nll sum, the mask count, the all-correct
    count and the sequences: the exact corpus perplexity and the sequence
    accuracy from one stream."""

    def __init__(self, **_):
        self.reset()

    def update(self, preds, labels=None):
        preds = np.asarray(preds)
        self.nll += float(preds[:, 0].sum())
        self.tokens += float(preds[:, 1].sum())
        self.correct += float(preds[:, 2].sum())
        self.seqs += preds.shape[0]

    def accumulate(self) -> Dict[str, float]:
        ppl = float(np.exp(min(self.nll / max(self.tokens, 1.0), 20.0)))
        return {"ppl": ppl, "acc": self.correct / max(self.seqs, 1), "tokens": self.tokens}

    def reset(self):
        self.nll = 0.0
        self.tokens = 0.0
        self.correct = 0.0
        self.seqs = 0


class GPTEvalModule(GPTModule):
    """A GPT module for evaluation: the loss always with ``train=False``,
    per-sequence prediction rows and their metric."""

    module_names = ("GPTEvalModule", "GPTModule")

    def loss_fn(self, model, batch, *, dropout_seed=None, train=False):
        return super().loss_fn(model, batch, dropout_seed=dropout_seed, train=False)

    def _rows(self, logits: torch.Tensor, batch) -> torch.Tensor:
        logits = logits.float()
        labels = batch["labels"].long()
        mask = batch["loss_mask"].float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = (lse - picked) * mask
        correct = (logits.argmax(dim=-1) == labels) | (mask == 0)
        all_correct = correct.all(dim=-1).float()
        return torch.stack([nll.sum(-1), mask.sum(-1), all_correct], dim=-1)

    @torch.no_grad()
    def predict_fn(self, model, batch) -> torch.Tensor:
        """[b, 3] float32 rows: (masked nll sum, mask count, all-correct)."""
        logits = gpt.forward(model, batch["tokens"], self.config,
                             position_ids=batch.get("position_ids"), train=False)
        return self._rows(logits, batch)

    @torch.no_grad()
    def loss_and_predict(self, model, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's masked-mean loss and :meth:`predict_fn`'s rows from
        one forward (the loss is ``loss_fn``'s: the masked nll sum over the
        mask count, at least 1)."""
        rows = self.predict_fn(model, batch)
        return rows[:, 0].sum() / torch.clamp(rows[:, 1].sum(), min=1.0), rows

    def build_metric(self) -> LMEvalMetric:
        return LMEvalMetric()
