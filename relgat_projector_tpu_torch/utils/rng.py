"""The port's random streams.

``jax.random`` keys have no torch counterpart that gives the same numbers,
so the port draws from explicit ``torch.Generator``s: ``host`` (CPU) for the
int32 attention-dropout seeds, which the kernels take as launch arguments,
and ``device`` for output-dropout masks and negatives, drawn where the
tensors live. Parity tests therefore inject negatives and switch output
dropout off; the attention-dropout hash itself matches bit for bit.

``get_state`` / ``from_state`` carry both generators through a checkpoint,
so a resumed run draws the numbers the uninterrupted run would have drawn.
A device generator's state only loads onto a device of the same type: a
CUDA Philox state and a CPU Mersenne-Twister state do not convert.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from relgat_projector_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class RngStreams:
    host: torch.Generator
    device: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device: DeviceLike = "cuda") -> "RngStreams":
        dev = resolve_device(device)
        host = torch.Generator().manual_seed(int(seed))
        on_device = torch.Generator(device=dev).manual_seed(int(seed) + 1)
        return cls(host=host, device=on_device)

    def int32_seed(self) -> int:
        return int(
            torch.randint(-(2**31), 2**31, (1,), generator=self.host,
                          dtype=torch.int64)
        )

    def get_state(self) -> Dict[str, Any]:
        """Both generators' states as CPU byte tensors, and the device type
        the device generator belongs to."""
        return {
            "host": self.host.get_state(),
            "device": self.device.get_state(),
            "device_type": self.device.device.type,
        }

    @classmethod
    def from_state(
        cls, state: Dict[str, Any], device: DeviceLike = "cuda"
    ) -> "RngStreams":
        dev = resolve_device(device)
        if state["device_type"] != dev.type:
            raise ValueError(
                f"a {state['device_type']} generator state cannot be loaded "
                f"onto {dev.type}: the generators' states do not convert"
            )
        host = torch.Generator()
        host.set_state(state["host"])
        on_device = torch.Generator(device=dev)
        on_device.set_state(state["device"])
        return cls(host=host, device=on_device)
