"""Batch inference over Datasets (port of ``ray_tpu/train/batch_predictor.py``;
reference: ``python/ray/train/batch_predictor.py`` + the ``Predictor``
abstraction).

``BatchPredictor.from_checkpoint(ckpt, MyPredictor)`` fans a dataset's
blocks through a pool of predictor actors -- each actor materializes the
model ONCE from the checkpoint, then scores batches as they stream in
(``map_batches`` with ``ActorPoolStrategy``).

``CudaPredictor`` is the counterpart of ``JaxPredictor``: it holds an
``apply_fn(params, batch)`` and the checkpoint's parameters on its device.

What differs from the JAX module, and why: the scoring actors build their
predictor in their constructor (``map_batches`` with a callable class),
where the reference builds it on the first batch inside a closure that
the cluster backend cannot send by reference; either way each actor
builds one predictor.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Type

from ray_tpu_torch.train.checkpoint import Checkpoint


class Predictor:
    """Stateful scorer (reference ``ray.train.predictor.Predictor``)."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch):
        raise NotImplementedError


class CudaPredictor(Predictor):
    """Predictor over ``apply_fn(params, batch) -> predictions`` on a CUDA
    device (``cuda`` unless ``device`` names another; without CUDA the
    constructor raises). The checkpoint dict must hold ``params``, a tree
    of arrays (numpy or tensors), which are put on the device once, at
    construction. Each numpy batch (a dict of columns or one array) is
    turned into tensors on the device, ``apply_fn`` runs under
    ``torch.inference_mode()``, and its outputs (a tensor or a dict of
    them) come back as numpy arrays, bf16 upcast to fp32 (numpy has no
    bf16). There is no counterpart of ``JaxPredictor``'s ``jit=``: the
    port runs its models eagerly and compiles nothing; the kernels
    ``apply_fn`` reaches are the compiled part."""

    def __init__(self, apply_fn: Callable, params: Any, device=None):
        import numpy as np
        import torch

        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch._tree import tree_map

        self._device = resolve_device(device)
        self._apply = apply_fn

        def leaf(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x))  # a writable copy
            return x.to(self._device)

        self._params = tree_map(leaf, params)

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Optional[Callable] = None,
                        device=None) -> "CudaPredictor":
        if apply_fn is None:
            raise ValueError("CudaPredictor.from_checkpoint needs apply_fn=")
        data = checkpoint.to_dict()
        if "params" not in data:
            raise ValueError("checkpoint has no 'params' entry")
        return cls(apply_fn, data["params"], device=device)

    def predict(self, batch):
        import numpy as np
        import torch

        from ray_tpu_torch._tree import tree_map

        def to_device(x):
            return torch.from_numpy(np.array(x)).to(self._device)

        def to_numpy(t):
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

        inputs = ({k: to_device(v) for k, v in batch.items()}
                  if isinstance(batch, dict) else to_device(batch))
        with torch.inference_mode():
            out = self._apply(self._params, inputs)
        return tree_map(to_numpy, out)


class _Scorer:
    """One scoring actor's predictor: built once, in the actor, from the
    checkpoint; called on every batch the actor maps."""

    def __init__(self, checkpoint, predictor_cls, predictor_kwargs):
        self._predictor = predictor_cls.from_checkpoint(
            checkpoint, **predictor_kwargs)

    def __call__(self, batch):
        out = self._predictor.predict(batch)
        # Normalize bare arrays into a column so the result is a
        # well-formed columnar block.
        if not isinstance(out, dict):
            out = {"predictions": out}
        return out


class BatchPredictor:
    """Scores datasets with a pool of predictor actors."""

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **predictor_kwargs):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(
        self,
        dataset,
        *,
        batch_size: int = 256,
        batch_format: str = "numpy",
        min_scoring_workers: int = 1,
        max_scoring_workers: int = 4,
    ):
        """Returns a Dataset of predictions. Each scoring actor builds its
        predictor once and reuses it for every batch it scores."""
        from ray_tpu_torch.data.dataset import ActorPoolStrategy

        return dataset.map_batches(
            _Scorer,
            batch_size=batch_size,
            batch_format=batch_format,
            compute=ActorPoolStrategy(
                min_size=min_scoring_workers, max_size=max_scoring_workers),
            fn_constructor_args=(self._checkpoint, self._predictor_cls,
                                 self._predictor_kwargs),
        )
