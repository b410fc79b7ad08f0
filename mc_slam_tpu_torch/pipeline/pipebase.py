"""Shared pipeline constants (port of mc_slam_tpu/pipeline/pipebase.py): the
tracking state machine of the reference, include/Tracking.h:113-120; and
`HostCopy`, the device->host copy that the deferred harvests read."""
import torch

NO_IMAGES_YET, NOT_INITIALIZED, OK, LOST = range(4)


class HostCopy:
    """A tensor's copy to the host (the JAX package's `copy_to_host_async` +
    `is_ready`). With `wait=False` a CUDA tensor is copied without blocking
    into a pinned buffer of its own and a CUDA event is recorded after the
    copy: `ready()` asks the event, `numpy()` waits for it. Reading the
    buffer before the event completes would give stale numbers without an
    error, so the buffer is only reachable through `numpy()`. With
    `wait=True`, and on the CPU, the copy has landed when this returns."""

    def __init__(self, x: torch.Tensor, wait: bool = False):
        self._event = None
        if x.device.type != "cuda":
            self._host = x.detach()
        elif wait:
            self._host = x.cpu()
        else:
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self):
        """The values, as a numpy array of their own (waits for the copy)."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host.numpy().copy()
