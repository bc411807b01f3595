"""Model factory: ``ModelConfig.family`` -> the family module, bundled as
uniform (loss_fn, prefill, decode_step, param_defs, cache_defs,
make_inputs, input_specs) functions for the train loop, the serve loop and
the dry-run; the port of the JAX package's ``models/factory.py`` for every
family: dense, moe, encdec, vlm, hybrid (``rglru``), ssm (``mamba``) and
the paper's logistic regression (``logreg``: a loss and its inputs, no
serve path). ``input_specs(shape_cfg, mesh=None)`` is the dry-run's batch:
`TensorSpec`s, no data.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.core.objective import default_device
from repro_torch.data.synthetic_lm import lm_batch_specs
from repro_torch.sharding.rules import ParamDef, batch_pspec, spec_on
from repro_torch.utils.tree import tree_map

_MODULES = {"dense": "transformer", "moe": "moe", "encdec": "encdec",
            "vlm": "vlm", "hybrid": "rglru", "ssm": "mamba"}


@dataclass
class ModelBundle:
    cfg: ModelConfig
    device: torch.device                 # where params and caches live
    param_defs: Any                      # ParamDef dict
    cast: Callable                       # master params -> activation-dtype copies
    loss_fn: Callable                    # (params, batch) -> scalar
    prefill_fn: Optional[Callable]       # (params, batch, cache_len) -> (logits, cache)
    decode_fn: Optional[Callable]        # (params, cache, tokens, pos) -> (logits, cache)
    cache_defs: Optional[Callable]       # (batch, seq) -> ParamDef dict
    make_inputs: Callable                # (batch, seq, gen) -> concrete batch
    input_specs: Callable                # (shape_cfg, mesh=None) -> TensorSpec batch


def _modality_extra(cfg: ModelConfig) -> Dict:
    """Stub frontend tensors the input pipeline supplies beside the tokens:
    {name: shape after the batch dimension}."""
    if cfg.family == "encdec":
        return {"enc_feats": (cfg.encoder_seq, cfg.encoder_feature_dim)}
    if cfg.family == "vlm":
        return {"image_embeds": (cfg.num_image_tokens, cfg.image_embed_dim)}
    return {}


def _batch_specs(shapes: Dict, mesh):
    """{name: (shape, dtype)} -> `TensorSpec`s, each placed by
    `batch_pspec` on ``mesh`` (the leading dim over the batch axes, unpadded
    where they do not divide it)."""
    spec = batch_pspec(mesh) if mesh is not None else None
    return {name: spec_on(shape, dtype, spec, mesh)
            for name, (shape, dtype) in shapes.items()}


def _lm_input_specs(cfg: ModelConfig, b: int, s: int, mesh=None,
                    extra: Dict = None):
    """The JAX package's shape-only ``_lm_inputs``: `lm_batch_specs` and
    the modality stubs in bf16."""
    return {**lm_batch_specs(b, s, mesh), **_batch_specs(
        {name: ((b, *rest), torch.bfloat16)
         for name, rest in (extra or {}).items()}, mesh)}


def build_model(cfg: ModelConfig, device=None) -> ModelBundle:
    """The bundle of ``cfg`` on ``device`` (default: the card; raises where
    there is none rather than moving to the CPU)."""
    fam = cfg.family
    if fam not in _MODULES and fam != "logreg":
        raise ValueError(f"unknown family {fam!r}")
    device = default_device(device)
    if fam == "logreg":
        return _build_logreg(cfg, device)
    mod = importlib.import_module(f"repro_torch.models.{_MODULES[fam]}")
    act_dtype = getattr(torch, cfg.dtype)
    extra = _modality_extra(cfg)

    def cast(params: Dict) -> Dict:
        """f32 master params -> activation-dtype compute copies. A leaf
        already in that dtype is returned as it is, so casting cast params
        costs nothing: the serve session casts once, and the functions
        below, which cast as the JAX package's do, then reuse its copies."""
        return tree_map(lambda x: x.to(act_dtype) if x.is_floating_point()
                        else x, params)

    def loss_fn(params, batch):
        """The cast is inside the loss, so gradients with respect to the
        float32 master params come back in float32."""
        return mod.loss_fn(cfg, cast(params), batch)

    def make_inputs(batch: int, seq: int, gen: torch.Generator):
        """A concrete LM batch on ``gen``'s device: tokens and targets drawn
        in turn from ``gen`` in [0, vocab), mask ones, and the modality
        stubs (`_modality_extra`) as float32 ones (the JAX package's
        concrete ``_lm_inputs``, whose tokens and targets share one
        key)."""
        shape = (batch, seq)
        tokens, targets = (torch.randint(0, cfg.vocab_size, shape,
                                         generator=gen, device=gen.device,
                                         dtype=torch.int32) for _ in range(2))
        out = {"tokens": tokens, "targets": targets,
               "mask": torch.ones(shape, dtype=torch.float32,
                                  device=gen.device)}
        for name, rest in extra.items():
            out[name] = torch.ones((batch, *rest), dtype=torch.float32,
                                   device=gen.device)
        return out

    def prefill_fn(params, batch, cache_len):
        params = cast(params)
        if fam == "encdec":
            return mod.prefill(cfg, params, batch["enc_feats"],
                               batch["tokens"], cache_len)
        if fam == "vlm":
            return mod.prefill(cfg, params, batch["tokens"],
                               batch["image_embeds"], cache_len)
        return mod.prefill(cfg, params, batch["tokens"], cache_len)

    def decode_fn(params, cache, tokens, pos):
        return mod.decode_step(cfg, cast(params), cache, tokens, pos)

    def cache_defs(batch, seq):
        return mod.cache_defs(cfg, batch, seq)

    def input_specs(shape_cfg: ShapeConfig, mesh=None):
        return _lm_input_specs(cfg, shape_cfg.global_batch, shape_cfg.seq_len,
                               mesh, extra)

    return ModelBundle(cfg=cfg, device=device, param_defs=mod.param_defs(cfg),
                       cast=cast, loss_fn=loss_fn, prefill_fn=prefill_fn,
                       decode_fn=decode_fn, cache_defs=cache_defs,
                       make_inputs=make_inputs, input_specs=input_specs)


# ---------------------------------------------------------------------------
# The paper's own workload as a "model": logistic regression
# ---------------------------------------------------------------------------

def _build_logreg(cfg: ModelConfig, device: torch.device) -> ModelBundle:
    """The JAX package's ``_build_logreg``: params ``{"w": zeros[F]}``, the
    mean logistic loss over a batch ``{"X": [b, F], "y": [b] in ±1}`` plus
    (λ/2)|w|², and concrete inputs. No serve path (``prefill_fn`` None) and
    no cast (float32 throughout)."""
    defs = {"w": ParamDef((cfg.num_features,), ("features",), "zeros")}

    def loss_fn(params, batch):
        w = params["w"]
        margins = batch["y"] * batch["X"].matmul(w)
        return (torch.logaddexp(torch.zeros_like(margins), -margins).mean()
                + 0.5 * cfg.l2_reg * torch.dot(w, w))

    def make_inputs(batch: int, seq: int, gen: torch.Generator):
        """X standard normal [batch, F] and y = sign(normal + 0.1) [batch],
        drawn in turn from ``gen`` on its device (``seq`` is unused, as in
        the JAX package, whose X and y share one key)."""
        X = torch.randn((batch, cfg.num_features), generator=gen,
                        device=gen.device)
        y = torch.sign(torch.randn((batch,), generator=gen, device=gen.device)
                       + 0.1)
        return {"X": X, "y": y}

    def input_specs(shape_cfg: ShapeConfig, mesh=None):
        b = shape_cfg.global_batch
        return _batch_specs({"X": ((b, cfg.num_features), torch.float32),
                             "y": ((b,), torch.float32)}, mesh)

    return ModelBundle(cfg=cfg, device=device, param_defs=defs,
                       cast=lambda params: params, loss_fn=loss_fn,
                       prefill_fn=None, decode_fn=None, cache_defs=None,
                       make_inputs=make_inputs, input_specs=input_specs)
