"""The rule for a metric that runs a network: the network is not state.

FID, KID, IS and LPIPS call a feature extractor or a distance network. In
the JAX package it is a plain attribute outside the metric's state. Here a
metric is an ``nn.Module``, so a network held as a child module would enter
``state_dict()`` (about 24M Inception parameters), and with it the
checkpoint, ``state_fingerprint``, ``load_state_dict(strict=True)`` and the
sync payload, and ``set_dtype``/``half()`` would cast its weights.
:class:`NetworkMetric` keeps the network out of the module tree: the
metric's states are exactly the JAX package's, ``.to(device)``/``.cuda()``
move the network along, and a dtype cast leaves it alone (its precision is
its own ``dtype=``).
"""
from typing import Any, Callable

from torch import nn

from metrics_tpu_torch.core.metric import Metric


class NetworkMetric(Metric):
    """A :class:`~metrics_tpu_torch.Metric` that calls a network held
    outside its states (set with :meth:`_set_network`)."""

    _network_attr: str = ""

    def _set_network(self, name: str, network: Callable) -> None:
        # object's setattr: not registered as a child module
        object.__setattr__(self, name, network)
        object.__setattr__(self, "_network_attr", name)

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "NetworkMetric":
        this = super()._apply(fn, *args, **kwargs)
        network = this.__dict__.get(this._network_attr)
        if isinstance(network, nn.Module):
            network.to(this.device)  # moved with the metric, never cast
        return this
