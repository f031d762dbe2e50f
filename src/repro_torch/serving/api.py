"""Public serving API: text-in/text-out generation over the PaDG server,
with per-token streaming callbacks (the "typewriter mode" of §3.3).

Counterpart of ``repro.serving.api`` over the port's ``PaDGServer`` and
``EngineConfig``: its engines run on ``econf.device``, which is ``cuda``
unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO
from repro_torch.data.pipeline import ByteTokenizer
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.padg_server import PaDGServer


@dataclasses.dataclass
class GenerationResult:
    prompt: str
    text: str
    tokens: List[int]
    ttft_s: float
    avg_tpot_s: Optional[float]


class EcoServeAPI:
    """Batched generate() over N real PaDG instances."""

    def __init__(self, cfg: ModelConfig, n_instances: int = 2,
                 slo: SLO = SLO(ttft=60.0, tpot=10.0),
                 econf: EngineConfig = EngineConfig(), seed: int = 0):
        self.cfg = cfg
        self.tok = ByteTokenizer(cfg.vocab_size)
        self.server = PaDGServer(cfg, n_instances, slo, econf, seed=seed)

    def generate(self, prompts: List[str], max_new_tokens: int = 16,
                 stream: Optional[Callable[[int, int], None]] = None,
                 ) -> List[GenerationResult]:
        reqs = []
        for i, p in enumerate(prompts):
            ids = self.tok.encode(p)
            ids = ids[: self.server.econf.max_seq_len - max_new_tokens - 1]
            reqs.append(Request(rid=i, arrival_time=0.0,
                                prompt_len=len(ids),
                                output_len=max_new_tokens,
                                prompt_tokens=ids))
        self.server.serve(reqs)
        # the local reqs carry the generated tokens and timings directly
        # (keying stats.finished by rid would collide across generate()
        # calls, which all number their requests from 0)
        out = []
        for i, p in enumerate(prompts):
            r = reqs[i]
            if stream:
                for t in r.generated:
                    stream(i, t)
            out.append(GenerationResult(
                prompt=p,
                text=self.tok.decode(r.generated),
                tokens=list(r.generated),
                ttft_s=r.ttft or 0.0,
                avg_tpot_s=r.avg_tpot))
        return out

    def close(self) -> None:
        """Release the server's actor-registry entries."""
        self.server.shutdown()

    def __enter__(self) -> "EcoServeAPI":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
