"""Dense FFN variants: gated (SwiGLU/GeGLU) and plain (GELU / squared-ReLU)
(port of ``repro/models/mlp.py``).

Nemotron-4 uses squared-ReLU without gating [arXiv:2402.16819]; the Llama/
Mistral/Qwen family uses SwiGLU; Whisper uses GELU.  The weights keep the
reference's (in, out) layout, so ``x @ w`` as there.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ACTIVATIONS

GATED = {"swiglu": "silu", "geglu": "gelu"}


# The reference's sharding of each leaf over the "model" axis (the hidden
# dimension), as spec tuples (repro/models/mlp.py:17-20).
PARAM_SPECS = {"w_in": (None, "model"), "w_gate": (None, "model"),
               "w_out": ("model", None)}


def mlp_params(make, prefix: str, *, d_model: int, d_ff: int,
               activation: str) -> torch.nn.ParameterDict:
    p = {"w_in": make(f"{prefix}.w_in", (d_model, d_ff)),
         "w_out": make(f"{prefix}.w_out", (d_ff, d_model))}
    if activation in GATED:
        p["w_gate"] = make(f"{prefix}.w_gate", (d_model, d_ff))
    return torch.nn.ParameterDict(p)


def mlp(params, x: torch.Tensor, *, activation: str) -> torch.Tensor:
    if activation in GATED:
        act = ACTIVATIONS[GATED[activation]]
        h = act(x @ params["w_gate"]) * (x @ params["w_in"])
    else:
        h = ACTIVATIONS[activation](x @ params["w_in"])
    return h @ params["w_out"]
