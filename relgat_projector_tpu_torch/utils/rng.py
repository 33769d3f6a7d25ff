"""The port's random streams.

``jax.random`` keys have no torch counterpart that gives the same numbers,
so the port draws from explicit ``torch.Generator``s: ``host`` (CPU) for the
int32 attention-dropout seeds, which the kernels take as launch arguments,
and ``device`` for output-dropout masks and negatives, drawn where the
tensors live. Parity tests therefore inject negatives and switch output
dropout off; the attention-dropout hash itself matches bit for bit.
"""

from __future__ import annotations

import dataclasses

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
