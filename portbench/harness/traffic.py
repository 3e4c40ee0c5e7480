"""The one traffic generator: a configuration's samples and a mix's passes,
made on the device from ``--seed``.

A configuration gives the classes, the shape of one sample, the samples of
one evaluation pass and how many distinct samples the card holds (cycled
when fewer than a pass); a mix gives the batch and the form of the preds
(``probs``: softmax probabilities; ``labels``: their argmax, as evaluation
code that takes it before the metric sends). The scores are those of an informative model: standard normal logits
with the true class's raised by the configuration's ``logit_boost``, the
model of ``chip_smoke.py``'s ``_curve_data`` (commit 1e60dca8), made here on
the card instead of by numpy. Every seed gives the same sizes; only the
values differ.
"""
from dataclasses import dataclass
from typing import List, Tuple

import torch

_MASK = (1 << 64) - 1
INPUTS = (0,)  # the stream the inputs are drawn from
READS = (0, 1)  # the stream that picks the window's sampled reads


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit generator seed for ``(seed, *stream)`` (splitmix64 steps), so
    that any whole ``--seed``, however large, gives each stream its own."""
    x = seed & _MASK
    for s in (0x5EED,) + stream:
        x = (x + 0x9E3779B97F4A7C15 + (s & _MASK)) & _MASK
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
        x ^= x >> 31
    return x >> 1


@dataclass
class Inputs:
    # one pass: views of [distinct, C, *shape] float32 scores or
    # [distinct, *shape] int64 labels, and of [distinct, *shape] int64 targets
    steps: List[Tuple[torch.Tensor, torch.Tensor]]
    samples_per_pass: int


def pass_samples(config: dict, mix: dict) -> Tuple[int, int, int]:
    """(samples a pass folds, distinct samples the card holds, batch)."""
    per_pass, batch = int(config["samples_per_pass"]), int(mix["batch"])
    distinct = min(int(config["distinct_samples"]), per_pass)
    if per_pass % batch or distinct % batch:
        raise ValueError(f"a pass of {per_pass} does not split into batches of {batch} (distinct {distinct})")
    return per_pass, distinct, batch


def make_inputs(config: dict, mix: dict, seed: int, device) -> Inputs:
    per_pass, distinct, batch = pass_samples(config, mix)
    classes, shape = int(config["classes"]), tuple(config["sample_shape"])
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *INPUTS))
    target = torch.randint(0, classes, (distinct,) + shape, generator=g, device=device)
    logits = torch.randn((distinct, classes) + shape, generator=g, device=device)
    logits.scatter_add_(1, target.unsqueeze(1), torch.full_like(target.unsqueeze(1), config["logit_boost"],
                                                                dtype=logits.dtype))
    # softmax over the classes, in place: the scores are the largest tensor
    logits.sub_(logits.amax(1, keepdim=True)).exp_()
    probs = logits.div_(logits.sum(1, keepdim=True))
    if mix["preds"] == "labels":
        preds = probs.argmax(1)
        del probs, logits
    elif mix["preds"] == "probs":
        preds = probs
    else:
        raise ValueError(f"unknown preds form {mix['preds']!r}")
    steps = []
    for j in range(per_pass // batch):
        o = (j * batch) % distinct
        steps.append((preds[o:o + batch], target[o:o + batch]))
    return Inputs(steps, per_pass)
