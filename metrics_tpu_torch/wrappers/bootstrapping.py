"""BootStrapper: bootstrapped confidence intervals of any metric.

Counterpart of ``metrics_tpu/wrappers/bootstrapping.py``, with its draws:
the key is ``jax.random.PRNGKey(seed)`` held on the metric's device
(``ops/prng.py``), each copy takes ``key, subkey = split(key)`` per update,
and a copy's resample is ``jax.random.poisson(subkey, 1, (n,))`` counts
expanded with ``repeat_interleave`` (each row repeated its count) or
``jax.random.randint(subkey, (n,), 0, n)``, so one seed resamples the same
rows in both packages.

The copies of the base metric are not state: as in the JAX package, whose
``state_dict()`` of a BootStrapper holds only its own (empty) states, they
stay out of ``state_dict()``, checkpoints, fingerprints and the sync
payload. They are a plain list, not child modules; ``.to()``/``.cuda()``
move them and the key (the pattern of ``image/_extractor.py``).
"""
from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops import prng
from metrics_tpu_torch.utils.data import apply_to_collection


def _bootstrap_samplers(keys: torch.Tensor, size: int, sampling_strategy: str = "poisson") -> List[torch.Tensor]:
    """One index tensor per key of ``keys`` (``[B, 2]``), each resampling a
    batch of ``size`` rows with replacement, as the JAX sampler does for that
    key alone. The Poisson draw runs one loop for the whole batch of keys,
    and the lengths of the ``B`` resamples are read once."""
    if sampling_strategy == "poisson":
        counts = prng.poisson(keys, 1.0, size)
        lengths = counts.sum(dim=1).tolist()
        rows = torch.arange(size, device=keys.device).repeat(len(lengths))
        flat = torch.repeat_interleave(rows, counts.reshape(-1), output_size=sum(lengths))
        return list(flat.split(lengths))
    if sampling_strategy == "multinomial":
        return list(prng.randint(keys, size, 0, size).unbind(0))
    raise ValueError("Unknown sampling strategy")


def _bootstrap_sampler(key: torch.Tensor, size: int, sampling_strategy: str = "poisson") -> torch.Tensor:
    """Indices that resample a batch of ``size`` rows with replacement, for
    one key ``[2]`` (the JAX package's ``_bootstrap_sampler``)."""
    return _bootstrap_samplers(key.unsqueeze(0), size, sampling_strategy)[0]


class BootStrapper(Metric):
    r"""Keeps ``num_bootstraps`` copies of a base metric; every update feeds
    each copy a with-replacement resample of the batch along dim 0.
    ``compute()`` gives the mean, the standard deviation (ddof 1), the
    ``quantile`` (linear) and the raw values over the copies. The wrapper
    lives on its base metric's device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BootStrapper, MeanSquaredError
        >>> boot = BootStrapper(MeanSquaredError(device="cpu"), num_bootstraps=20, seed=0)
        >>> boot.update(torch.linspace(0, 1, 64), torch.linspace(0, 1, 64) + 0.1)
        >>> out = boot.compute()
        >>> sorted(out)
        ['mean', 'std']
        >>> round(float(out["mean"]), 3)
        0.01
    """

    #: ``update`` advances the resampling PRNG key, an instance-attribute
    #: side effect declared as the JAX package declares it, so metricslint and
    #: the compute-group/compiled machinery know about the latch. The wrapper
    #: never joins a compute group (no ``update_identity``) and declares no
    #: states, so no program compiles it either.
    _group_shared_attrs = ("_key",)

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, torch.Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: int = 0,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu_torch.Metric but received {base_metric}"
            )
        super().__init__(compute_on_step, dist_sync_on_step, process_group, dist_sync_fn, device=base_metric.device)
        # a plain list: nn.Module registers no child module from it
        self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but recieved {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self._key = prng.prng_key(seed, self.device)

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "BootStrapper":
        this = super()._apply(fn, *args, **kwargs)
        for m in this.metrics:
            m._apply(fn, *args, **kwargs)
        this._key = this._key.to(this.device)  # moved, never cast
        return this

    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        """Resample the inputs along dim 0 and update every copy."""
        args_sizes = apply_to_collection(args, torch.Tensor, len)
        kwargs_sizes = list(apply_to_collection(kwargs, torch.Tensor, len).values())
        if len(args_sizes) > 0:
            size = args_sizes[0]
        elif len(kwargs_sizes) > 0:
            size = kwargs_sizes[0]
        else:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        subkeys = []
        for _ in range(self.num_bootstraps):
            keys = prng.split(self._key)
            self._key, subkey = keys[0], keys[1]
            subkeys.append(subkey)
        samples = _bootstrap_samplers(torch.stack(subkeys), size, self.sampling_strategy)
        for m, sample_idx in zip(self.metrics, samples):
            new_args = apply_to_collection(args, torch.Tensor, lambda x: x.index_select(0, sample_idx))
            new_kwargs = apply_to_collection(kwargs, torch.Tensor, lambda x: x.index_select(0, sample_idx))
            m.update(*new_args, **new_kwargs)

    def compute(self) -> Dict[str, torch.Tensor]:
        """Any of ``mean``/``std``/``quantile``/``raw`` over the copies."""
        computed_vals = torch.stack([m.compute() for m in self.metrics], dim=0)
        vals = computed_vals if computed_vals.is_floating_point() else computed_vals.to(torch.float32)
        output_dict: Dict[str, torch.Tensor] = {}
        if self.mean:
            output_dict["mean"] = torch.mean(vals, dim=0)
        if self.std:
            output_dict["std"] = torch.std(vals, dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=vals.dtype, device=vals.device)
            output_dict["quantile"] = torch.quantile(vals.reshape(-1), q)  # over all values, as jnp.quantile
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()
