"""Metrics inside a training loop, in PyTorch: the counterpart of
``examples/train_loop_integration.py``.

The reference integrates with PyTorch Lightning by virtue of ``Metric`` being
an ``nn.Module``: metrics are updated every step and computed and reset at
epoch end. Here the metric state is an explicit dict threaded through the
train step with the pure state API (``init_state`` → ``pure_update`` →
``pure_compute``), so on the card the whole step (forward, loss, backward,
``Adam(capturable=True)`` and both metric updates) is captured once as ONE
CUDA graph and replayed every step, as the JAX example's step is one XLA
program. On the CPU the same step runs eagerly.

The model starts from the JAX example's parameters: ``init_params`` draws
them with ``metrics_tpu_torch/ops/prng.py``, ``jax.random`` under
``PRNGKey(seed)`` (a float32 normal within 4 ulps of JAX's).

Run:
    python examples/torch_train_loop_integration.py               # on the card, the step as one CUDA graph
    python examples/torch_train_loop_integration.py --eager       # on the card, the step op by op
    python examples/torch_train_loop_integration.py --device cpu  # on the host
"""
import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

from metrics_tpu_torch import Accuracy, AverageMeter, MetricCollection  # noqa: E402
from metrics_tpu_torch.ops import prng  # noqa: E402
from metrics_tpu_torch.utils.device import full_float32, resolve_device  # noqa: E402

NUM_CLASSES = 5
FEATURES = 16
HIDDEN = 32
LR = 1e-2
#: Eager steps on a side stream before the capture (allocates the optimizer
#: state and the autograd buffers, latches Accuracy's input mode); the
#: parameters and the optimizer state are put back after them.
WARMUP_STEPS = 2


def init_params(key: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The JAX example's ``init_params``: ``split(key)``, then each weight a
    normal draw times 0.1, zero biases; on the key's device."""
    k1, k2 = prng.split(key)
    return {
        "w1": prng.normal(k1, (FEATURES, HIDDEN)) * 0.1,
        "b1": torch.zeros(HIDDEN, device=key.device),
        "w2": prng.normal(k2, (HIDDEN, NUM_CLASSES)) * 0.1,
        "b2": torch.zeros(NUM_CLASSES, device=key.device),
    }


class MLP(nn.Module):
    """``relu(x @ w1 + b1) @ w2 + b2``, the JAX example's ``forward``."""

    def __init__(self, params: Dict[str, torch.Tensor]) -> None:
        super().__init__()
        for name, value in params.items():
            setattr(self, name, nn.Parameter(value.clone()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


class Trainer:
    """The model, Adam, the metrics and the loss meter, and one train step.

    ``graph=True`` (the default on the card) captures the step once as a
    CUDA graph over fixed input buffers and replays it; ``graph=False`` runs
    it op by op (the only form on the CPU)."""

    def __init__(self, seed: int = 0, batch_size: int = 64, device: Optional[Union[str, torch.device]] = None,
                 graph: Optional[bool] = None) -> None:
        self.device = resolve_device(device)
        self.graph = self.device.type == "cuda" if graph is None else graph
        if self.graph and self.device.type != "cuda":
            raise ValueError("a CUDA graph needs the card: pass graph=False on the CPU")
        self.model = MLP(init_params(prng.prng_key(seed, device=self.device)))
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=LR, capturable=self.graph)
        self.metrics = MetricCollection({
            "acc": Accuracy(num_classes=NUM_CLASSES, device=self.device),
            "macro_acc": Accuracy(num_classes=NUM_CLASSES, average="macro", device=self.device),
        })
        self.loss_meter = AverageMeter(device=self.device)
        # the step reads its batch from these buffers (a graph replays on fixed addresses)
        self.x = torch.zeros(batch_size, FEATURES, device=self.device)
        self.y = torch.zeros(batch_size, dtype=torch.int64, device=self.device)
        self.metric_state = self.metrics.init_state()
        self.loss_state = self.loss_meter.init_state()
        self.loss = torch.zeros((), device=self.device)
        self._graph: Optional[torch.cuda.CUDAGraph] = None

    def _step(self) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
        """Forward, loss, gradients, Adam and both metric updates on the
        batch in ``self.x``/``self.y``; the new states, not yet stored."""
        with full_float32():
            logits = self.model(self.x)
            loss = F.cross_entropy(logits, self.y)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        self.optimizer.step()
        metric_state = self.metrics.pure_update(self.metric_state, torch.softmax(logits.detach(), dim=-1), self.y)
        loss_state = self.loss_meter.pure_update(self.loss_state, loss.detach())
        return loss.detach(), metric_state, loss_state

    def _capture(self) -> None:
        params = [p.detach().clone() for p in self.model.parameters()]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for p, p0 in zip(self.model.parameters(), params):
                p.copy_(p0)
        # Adam's fresh state is step 0 and zero moments, in place
        for state in self.optimizer.state.values():
            for v in state.values():
                v.zero_()
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            loss, metric_state, loss_state = self._step()
            self.loss.copy_(loss)
            _copy_into(self.metric_state, metric_state)
            _copy_into(self.loss_state, loss_state)

    def start_epoch(self) -> None:
        """The epoch-start reset: fresh metric states (in place on the card,
        where the graph reads them)."""
        if self.graph:
            _copy_into(self.metric_state, self.metrics.init_state())
            _copy_into(self.loss_state, self.loss_meter.init_state())
        else:
            self.metric_state, self.loss_state = self.metrics.init_state(), self.loss_meter.init_state()

    def step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One train step on ``x`` ``[B, FEATURES]`` and ``y`` ``[B]``; the
        loss (the graph's output buffer on the card)."""
        self.x.copy_(x)
        self.y.copy_(y)
        if not self.graph:
            self.loss, self.metric_state, self.loss_state = self._step()
        else:
            if self._graph is None:
                self._capture()
            self._graph.replay()
        return self.loss

    def end_epoch(self) -> Dict[str, float]:
        """The epoch's metric values and mean loss."""
        values = {k: float(v) for k, v in self.metrics.pure_compute(self.metric_state).items()}
        values["loss"] = float(self.loss_meter.pure_compute(self.loss_state))
        return values


def _copy_into(dst: Dict, src: Dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def task_batches(num_epochs: int, steps_per_epoch: int, batch_size: int, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The JAX example's learnable synthetic task, batch for batch: the class
    is the argmax of a fixed random projection."""
    rng = np.random.RandomState(seed)
    proj = rng.randn(FEATURES, NUM_CLASSES).astype(np.float32)
    batches = []
    for _ in range(num_epochs * steps_per_epoch):
        x = rng.randn(batch_size, FEATURES).astype(np.float32)
        batches.append((x, (x @ proj).argmax(-1)))
    return batches


def run_training(num_epochs: int = 2, steps_per_epoch: int = 8, batch_size: int = 64, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None, graph: Optional[bool] = None,
                 ) -> List[Dict[str, float]]:
    """Per-epoch metric dicts (``acc``, ``macro_acc``, ``loss``) with
    epoch-end compute and epoch-start reset, as the JAX example's
    ``run_training``."""
    trainer = Trainer(seed, batch_size, device, graph)
    batches = [(torch.from_numpy(x).to(trainer.device), torch.from_numpy(y).to(trainer.device))
               for x, y in task_batches(num_epochs, steps_per_epoch, batch_size, seed)]
    history = []
    for epoch in range(num_epochs):
        trainer.start_epoch()
        for x, y in batches[epoch * steps_per_epoch:(epoch + 1) * steps_per_epoch]:
            trainer.step(x, y)
        history.append(trainer.end_epoch())
    return history


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--eager", action="store_true", help="run the step op by op on the card")
    args = parser.parse_args(argv)
    history = run_training(device=args.device, graph=False if args.eager else None)
    for i, epoch in enumerate(history):
        print(f"epoch {i}: " + ", ".join(f"{k}={v:.4f}" for k, v in epoch.items()))
    return history


if __name__ == "__main__":
    main()
