"""The states a configuration can hold, made on a device from the seed.

A configuration's ``"state"`` names a file ``states/<state>.py`` whose
``build(cfg, traffic, seed, device)`` returns one of these (or a state of
its own with the same methods): ``named()``, the leaves a snapshot holds;
``scalars()``, its non-tensor values; ``fill(k)``; ``numbers()``, the sizes
the metric readers need; and, for a state that trains, ``step()``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import arith
from .trainer import TransformerConfig, adamw, init_model, tokens_for_step, train_state_tensors, train_step


def model_config(cfg: Dict[str, Any]) -> TransformerConfig:
    """The trainer's sizes from a configuration in Hugging Face's names."""
    if cfg["activation_function"] != "relu":
        raise ValueError(f"the trainer's block has OPT's ReLU, not {cfg['activation_function']!r}")
    dtype = getattr(torch, cfg["torch_dtype"])
    return TransformerConfig(
        vocab_size=cfg["vocab_size"],
        d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_layers=cfg["num_hidden_layers"],
        d_ff=cfg["ffn_dim"],
        max_seq_len=cfg["max_position_embeddings"],
        dtype=dtype,
        param_dtype=dtype,
        dropout=cfg["dropout"],
    )


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ModelState:
    """The model's parameters alone (a serving replica's weights)."""

    def __init__(self, cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device: torch.device) -> None:
        self.tcfg = model_config(cfg)
        self.device = device
        self.seed = seed
        self.batch = traffic.get("batch", 0)
        torch.manual_seed(seed)  # the dropout masks
        self.model = init_model(self.tcfg, seed, device)
        self.app: Dict[str, Any] = {"model": self.model}

    def named(self) -> List[Tuple[str, torch.Tensor]]:
        return list(self.model.named_parameters())

    def scalars(self) -> Dict[str, int]:
        return {}

    def nbytes(self, on_device_only: bool = False) -> int:
        return sum(
            t.numel() * t.element_size()
            for _, t in self.named()
            if not on_device_only or t.device.type != "cpu"
        )

    @torch.no_grad()
    def fill(self, k: int) -> None:
        """Overwrite every leaf with a byte pattern that no restore of a
        sound snapshot leaves in place (what a restarted process finds in
        freshly allocated memory)."""
        for _, t in self.named():
            t.detach().reshape(-1).view(torch.uint8).fill_(0x5A ^ (k & 0xFF))
        sync(self.device)

    def numbers(self) -> Dict[str, float]:
        c = self.tcfg
        counts = arith.param_counts(c.vocab_size, c.d_model, c.n_layers, c.d_ff, c.max_seq_len)
        return {
            "state_bytes": self.nbytes(),
            "device_state_bytes": self.nbytes(on_device_only=True),
            "tokens_per_step": self.batch * c.max_seq_len,
            "flops_per_token": arith.train_flops_per_token(counts["non_embedding"], c.n_layers, c.d_model, c.max_seq_len),
        }


class TrainState(ModelState):
    """A training job's state: the model, :class:`trainer.AdamW` and a
    ``StateDict`` holding the step counter."""

    def __init__(self, cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device: torch.device) -> None:
        from torchsnapshot_tpu_torch import StateDict

        super().__init__(cfg, traffic, seed, device)
        self.steps = 0
        self.optimizer = adamw(self.model.parameters())
        self.progress = StateDict(step=0)
        self.app.update(optim=self.optimizer, progress=self.progress)

    def named(self) -> List[Tuple[str, torch.Tensor]]:
        return train_state_tensors(self.model, self.optimizer)

    def scalars(self) -> Dict[str, int]:
        return {"progress.step": self.progress["step"]}

    def step(self) -> None:
        """One training step, ended by a synchronize."""
        self.steps += 1
        tokens = tokens_for_step(self.tcfg, self.steps, self.batch, self.seed, self.device)
        train_step(self.model, self.optimizer, tokens)
        self.progress["step"] = self.steps
        sync(self.device)

    def fill(self, k: int) -> None:
        super().fill(k)
        self.progress["step"] = -1
