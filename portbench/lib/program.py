"""The system under test: the harness's one door into ``ray_tpu_torch``.

It builds what a cell drives from the cell's configuration file and the
weights the harness drew: ``LLMEngine`` for serving, the one-card
``build_llama_train_state`` step for training.  Everything else the
harness reads from the program goes through what these return: the
engine's ``stats()`` and the handles ``submit`` gives back, the train
step's optimizer state, and kernel names in the trace.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from portbench.lib import weights


def llama_config(cfg: dict, remat: bool = False):
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        hidden_dim=cfg["intermediate_size"],
        max_seq_len=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        dtype=getattr(torch, cfg["torch_dtype"]), remat=remat)


def engine(cfg: dict, seed: int, device: str):
    """An ``LLMEngine`` holding the seed's weights in the served dtype."""
    from ray_tpu_torch.serve.llm import LLMEngine

    lc = llama_config(cfg)
    sd = weights.state_dict(cfg, seed, lc.dtype, device)
    eng = LLMEngine(lc, params=sd, device=device, **cfg["engine"])
    del sd
    return eng


class _Drawn(Mapping):
    """The seed's weights in ``dtype``, drawn one group (a layer, the
    embedding, the head) at a time as the loader asks for them, so at
    most one group is held besides the model."""

    def __init__(self, cfg: dict, seed: int, dtype, device):
        self.cfg, self.seed, self.dtype, self.device = cfg, seed, dtype, device
        self._group, self._held = None, {}

    def __getitem__(self, name: str) -> torch.Tensor:
        group = name.split(".")[1] if name.startswith("layers.") \
            else name.split(".")[0]
        if group != self._group:
            self._held = draw_group(self.cfg, self.seed, group, self.dtype,
                                    self.device)
            self._group = group
        return self._held[name]

    def __iter__(self):
        raise TypeError("drawn lazily, by name")

    def __len__(self) -> int:
        raise TypeError("drawn lazily, by name")


def draw_group(cfg: dict, seed: int, group: str, dtype, device
               ) -> Dict[str, torch.Tensor]:
    """One group of the seed's weights: ``embed``, ``lm_head``,
    ``final_norm`` or a layer index."""
    if group == "embed":
        return {"embed.weight": weights.embed(cfg, seed, dtype, device)}
    if group == "lm_head":
        return {"lm_head.weight": weights.head(cfg, seed, dtype, device)}
    if group == "final_norm":
        return {"final_norm.scale": torch.ones(
            cfg["hidden_size"], dtype=torch.float32, device=device)}
    return weights.layer(cfg, seed, int(group), dtype, device)


def train_state(cfg: dict, seed: int, device: str):
    """(model, optimizer, step_fn) of the one-card train step, its fp32
    master weights the seed's."""
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.train.gspmd import build_llama_train_state, load_params

    t = cfg["train"]
    lc = llama_config(cfg, remat=bool(t["remat"]))
    mesh = make_mesh(MeshSpec(), devices=[device])
    params, opt, step_fn, _ = build_llama_train_state(
        lc, mesh, learning_rate=float(t["learning_rate"]),
        param_dtype=getattr(torch, t["param_dtype"]))
    load_params(params, _Drawn(cfg, seed, getattr(torch, t["param_dtype"]),
                               device))
    return params, opt, step_fn
