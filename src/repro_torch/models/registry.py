"""Architecture registry (port of ``repro.models.registry``): arch id ->
config, and the train, prefill and serve step functions of every
architecture the reference registers (decoder-only LMs and the
encoder-decoder); every input shape by name (``SHAPES``).

Shape semantics, as the reference's:
  * ``train_4k``     runs train_step   (tokens + labels, optimizer update)
  * ``prefill_32k``  runs prefill_step (prompt -> logits + KV cache)
  * ``decode_32k``   runs serve_step   (ONE token against a seq_len cache)
  * ``long_500k``    runs serve_step   (sub-quadratic archs only; others
                     declare the skip in their config module's SKIPS)

The dry-run half (``batch_specs``, ``param_specs``, ``state_specs``,
``cache_specs``, ``dryrun_cell``) builds abstract trees: the port's
initialisers run on the ``meta`` device (shapes and dtypes, no storage)
and their leaves become ``parallel.sharding.ShapeDtypeStruct``s, with
the reference's shardings under a mesh.  Parameter, train-state and
cache trees take the reference's stacked layout (``prefix``, ``stacks``
with a leading group dim, ``tail``), the layout the sharding rules
address, so the specs equal the reference's leaf by leaf; a cell's step
function takes them in that layout and runs the port's per-layer steps
on views of them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.parallel import sharding as SH

ARCHS: Dict[str, str] = {
    "qwen1.5-32b": "qwen1_5_32b",
    "gemma3-12b": "gemma3_12b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2.5-3b": "qwen2_5_3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "whisper-tiny": "whisper_tiny",
    "chameleon-34b": "chameleon_34b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-3b": "rwkv6_3b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def arch_module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str, smoke: bool = False):
    mod = arch_module(arch)
    return mod.smoke_config() if smoke else mod.config()


def arch_skips(arch: str) -> Dict[str, str]:
    return dict(getattr(arch_module(arch), "SKIPS", {}))


def cell_is_skipped(arch: str, shape: str) -> Optional[str]:
    """Reason string if this (arch x shape) cell is skipped, else None."""
    reason = arch_skips(arch).get(shape)
    if reason:
        return reason
    if is_encdec(get_config(arch)) and shape == "long_500k":
        return "enc-dec full attention — skip per the sub-quadratic rule"
    return None


def is_encdec(cfg) -> bool:
    return isinstance(cfg, ED.EncDecConfig)


def param_count(cfg) -> Tuple[int, int]:
    if is_encdec(cfg):
        return ED.param_count(cfg)
    return LM.param_count(cfg)


def model_flops(cfg, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6 * N(_active) * D_tokens for train; 2*N*D for
    forward-only shapes (prefill/decode)."""
    _, active = param_count(cfg)
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * active * shape.global_batch


def _optimizer(cfg, lr: float = 3e-4):
    from repro_torch.optim.adamw import adamw

    return adamw(lr, weight_decay=0.1)


def make_lm_train_step(cfg, remat: bool = True):
    return LM.make_train_step(cfg, _optimizer(cfg), remat=remat)


def make_encdec_train_step(cfg: ED.EncDecConfig):
    """-> (init_state, step), as ``lm.make_train_step``'s: AdamW (lr
    3e-4, weight decay 0.1) after clipping the global norm to 1.0;
    metrics ``loss``, ``grad_norm``."""
    from repro_torch.optim.adamw import apply_updates, clip_by_global_norm

    opt_init, opt_update = _optimizer(cfg)

    def init_state(generator: torch.Generator, device: DeviceLike = None):
        params = ED.init_params(cfg, generator, device)
        return {"params": params, "opt": opt_init(params)}

    def step(state, batch):
        params = state["params"]
        metrics, grads = LM.value_and_grad(
            lambda p: ED.encdec_loss(p, cfg, batch["frames"],
                                     batch["tokens"], batch["labels"]),
            params)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        updates, new_opt = opt_update(grads, state["opt"], params)
        metrics["grad_norm"] = gnorm
        return ({"params": apply_updates(params, updates), "opt": new_opt},
                metrics)

    return init_state, step


def make_train_step(cfg, remat: bool = True):
    if is_encdec(cfg):
        return make_encdec_train_step(cfg)
    return make_lm_train_step(cfg, remat=remat)


def make_prefill_step(cfg, max_len: int):
    if is_encdec(cfg):
        @torch.no_grad()
        def prefill(params, frames):
            """Encoder pass and the decoder's cache (``max_target``
            slots): the serving set-up."""
            enc_out = ED.encode(params, cfg, frames)
            return ED.init_dec_cache(params, cfg, enc_out, frames.shape[0],
                                     cfg.max_target)
        return prefill

    def prefill(params, tokens):
        return LM.prefill(params, cfg, tokens, max_len)
    return prefill


def make_serve_step(cfg):
    """One-token decode against an existing cache."""
    if is_encdec(cfg):
        def serve(params, cache, token, pos):
            return ED.decode_step(params, cfg, cache, token, pos)
        return serve

    def serve(params, cache, token, pos):
        return LM.decode_step(params, cfg, cache, token, pos)
    return serve


# ---------------------------------------------------------------------------
# abstract input specs per (arch x shape), mesh-sharded
# ---------------------------------------------------------------------------

_META = torch.device("meta")


def _sds(shape, dtype, sharding=None) -> SH.ShapeDtypeStruct:
    if sharding is None:
        return SH.ShapeDtypeStruct(shape, dtype)
    # drop spec entries that do not divide the dim (e.g. batch=1 cells)
    spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
    fixed = []
    for dim, names in enumerate(spec[: len(shape)]):
        if names is None:
            fixed.append(None)
            continue
        tup = names if isinstance(names, tuple) else (names,)
        size = 1
        for n in tup:
            size *= sharding.mesh.shape[n]
        fixed.append(names if shape[dim] % size == 0 else None)
    return SH.ShapeDtypeStruct(shape, dtype, sharding=SH.NamedSharding(
        sharding.mesh, SH.P(*fixed)))


def _named(mesh, *entries):
    if mesh is None:
        return None
    return SH.NamedSharding(mesh, SH.P(*entries))


def _dp(mesh):
    if mesh is None:
        return None
    axes = SH.dp_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def batch_specs(cfg, shape: ShapeSpec, mesh=None,
                seq_on_model: bool = False) -> Dict[str, Any]:
    """Abstract *data* inputs of the step function.  ``seq_on_model``
    lays the sequence dim of train/prefill token batches over ``model``
    (sequence parallelism)."""
    B, S = shape.global_batch, shape.seq_len
    dp = _dp(mesh)
    sm = "model" if seq_on_model else None
    i32 = torch.int32
    if is_encdec(cfg):
        # stub frontend: precomputed frame embeddings feed the encoder
        T = min(cfg.max_target, S)
        frames = _sds((B, S, cfg.d_model), torch.bfloat16,
                      _named(mesh, dp, None, None))
        if shape.kind == "train":
            return {"frames": frames,
                    "tokens": _sds((B, T), i32, _named(mesh, dp, None)),
                    "labels": _sds((B, T), i32, _named(mesh, dp, None))}
        if shape.kind == "prefill":
            return {"frames": frames}
        return {"token": _sds((B, 1), i32, _named(mesh, dp, None)),
                "pos": _sds((), i32, _named(mesh))}
    if shape.kind == "train":
        return {"tokens": _sds((B, S), i32, _named(mesh, dp, sm)),
                "labels": _sds((B, S), i32, _named(mesh, dp, sm))}
    if shape.kind == "prefill":
        return {"tokens": _sds((B, S), i32, _named(mesh, dp, sm))}
    return {"token": _sds((B, 1), i32, _named(mesh, dp, None)),
            "pos": _sds((), i32, _named(mesh))}


def _rules(cfg, fsdp: bool):
    return SH.lm_rules(fsdp=fsdp,
                       tied_embed=getattr(cfg, "tie_embeddings", True))


def _meta_params(cfg):
    """Parameters on ``meta``, in the reference's layout."""
    if is_encdec(cfg):
        return ED.init_params(cfg, torch.Generator(), _META)
    return LM.params_to_stacked(
        LM.init_params(cfg, torch.Generator(), _META), cfg)


def param_specs(cfg, mesh=None, fsdp: bool = False):
    """Abstract (no-allocation) parameter tree with shardings."""
    tree = SH.abstract(_meta_params(cfg))
    if mesh is None:
        return tree
    return SH.attach(tree, SH.make_shardings(tree, mesh, _rules(cfg, fsdp)))


def state_specs(cfg, mesh=None, fsdp: bool = False, zero1: bool = True):
    """Abstract train state {params, opt} with shardings; ``zero1``
    shards AdamW's moments over the data axes as well."""
    init_state, _ = make_train_step(cfg)
    state = init_state(torch.Generator(), _META)
    if not is_encdec(cfg):
        state = LM.train_state_to_stacked(state, cfg)
    tree = SH.abstract(state)
    if mesh is None:
        return tree
    rules = _rules(cfg, fsdp)
    p_sh = SH.make_shardings(tree["params"], mesh, rules)
    o_sh = SH.make_shardings(tree["opt"], mesh, rules)
    if zero1:
        o_sh = o_sh._replace(
            mu=SH.zero1_shardings(o_sh.mu, mesh, tree["opt"].mu),
            nu=SH.zero1_shardings(o_sh.nu, mesh, tree["opt"].nu))
    return {"params": SH.attach(tree["params"], p_sh),
            "opt": SH.attach(tree["opt"], o_sh)}


def cache_specs(cfg, shape: ShapeSpec, mesh=None):
    """Abstract decode cache (KV caches / recurrent state), with the
    context-parallel layout (the cache's sequence dim over ``model``)."""
    B, S = shape.global_batch, shape.seq_len
    if is_encdec(cfg):
        enc = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16,
                          device=_META)
        tree = ED.init_dec_cache(_meta_params(cfg), cfg, enc, B,
                                 cfg.max_target)
    else:
        cache = LM.init_cache(cfg, B, S, _META)
        tree = LM.layers_to_stacked(cache["blocks"], cfg, torch.stack)
    tree = SH.abstract(tree)
    if mesh is None:
        return tree
    return SH.attach(tree, SH.make_shardings(tree, mesh,
                                             SH.cache_rules(mesh)))


def materialize(tree: Any, device=_META) -> Any:
    """Empty tensors of an abstract tree's shapes and dtypes (on ``meta``
    by default: no storage)."""
    return SH.tree_map_with_path(
        lambda _, s: torch.empty(s.shape, dtype=s.dtype, device=device),
        tree)


# ---------------------------------------------------------------------------
# dry-run cell assembly: (fn, args) ready for fn(*materialize(args))
# ---------------------------------------------------------------------------

def _with_source_len(cfg: ED.EncDecConfig, S: int) -> ED.EncDecConfig:
    """Whisper's positional table must cover the assigned frame count."""
    return dataclasses.replace(cfg, max_source=max(cfg.max_source, S))


def depth_variant(cfg: LM.LMConfig, groups: int) -> LM.LMConfig:
    """Same arch with ``groups`` periods, flat: every layer in the
    unstacked ``prefix`` (the reference's depth-extrapolation variant;
    the port's eager count needs none, see ``launch/dryrun.py``)."""
    kinds = (tuple(cfg.prefix) + tuple(cfg.pattern) * groups
             + tuple(cfg.tail_kinds))
    return dataclasses.replace(cfg, n_layers=len(kinds), prefix=kinds)


def _cache_from_stacked(tree: dict, cfg: LM.LMConfig) -> dict:
    return {"blocks": LM.layers_from_stacked(tree, cfg)}


def dryrun_cell(arch: str, shape_name: str, mesh=None, smoke: bool = False,
                fsdp: Optional[bool] = None, remat: bool = True,
                seq_on_model: bool = False,
                depth_groups: Optional[int] = None, accum: int = 1,
                overrides: Optional[Dict[str, Any]] = None):
    """Returns (fn, args, meta) for one (arch x shape) cell.

    ``args`` are abstract (``ShapeDtypeStruct``, sharded under a mesh;
    no allocation) in the reference's layout, and ``fn(*materialize(
    args))`` runs the step the shape names on ``meta`` tensors.
    ``fsdp=None`` turns FSDP parameter sharding on for models too big
    for plain TP; ``depth_groups`` builds a flat depth variant
    (``depth_variant``); ``accum`` splits a train batch into
    micro-batches; ``overrides`` are ``dataclasses.replace`` fields of
    the config.  RWKV cells run the plain chunked WKV
    (``use_wkv_kernel=False``): the kernel's wrapper takes no ``meta``
    tensor; ``meta["notes"]`` says so."""
    cfg = get_config(arch, smoke=smoke)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if smoke:
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, 64),
            global_batch=min(shape.global_batch, 4))
    notes = []
    full_cfg = cfg
    if is_encdec(cfg):
        cfg = _with_source_len(cfg, shape.seq_len)
        full_cfg = cfg
    else:
        if any(m == "rwkv" for m, _ in cfg.kinds):
            cfg = dataclasses.replace(cfg, use_wkv_kernel=False)
            notes.append("WKV through the plain chunked form "
                         "(use_wkv_kernel=False): the kernel's wrapper "
                         "takes no meta tensor")
        if depth_groups is not None:
            cfg = depth_variant(cfg, depth_groups)

    # counts/FLOPs always refer to the FULL model, not a depth variant
    total, active = param_count(full_cfg)
    if fsdp is None:
        fsdp = total > 20_000_000_000 and shape.kind == "train"
    meta = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "params_total": total, "params_active": active,
        "model_flops": model_flops(full_cfg, shape), "fsdp": bool(fsdp),
        "scan_groups_full": (0 if is_encdec(full_cfg)
                             else full_cfg.n_scan_groups),
        "notes": notes,
    }
    batch = batch_specs(cfg, shape, mesh, seq_on_model=seq_on_model)
    enc = is_encdec(cfg)

    if shape.kind == "train":
        state = state_specs(cfg, mesh, fsdp=fsdp)
        if accum > 1 and not enc:
            _, step = LM.make_train_step(cfg, _optimizer(cfg), remat=remat,
                                         accum=accum)
        else:
            _, step = make_train_step(cfg, remat=remat)

        def train(state, batch):
            if not enc:
                state = LM.train_state_from_stacked(state, cfg)
            return step(state, batch)
        return train, (state, batch), meta

    params = param_specs(cfg, mesh, fsdp=False)
    as_port = ((lambda p: p) if enc
               else (lambda p: LM.params_from_stacked(p, cfg)))
    if shape.kind == "prefill":
        pre = make_prefill_step(cfg, max_len=shape.seq_len)

        def prefill(params, inputs):
            return pre(as_port(params), inputs)
        return prefill, (params, batch["frames" if enc else "tokens"]), meta

    cache = cache_specs(cfg, shape, mesh)
    serve = make_serve_step(cfg)

    def decode(params, cache, token, pos):
        if not enc:
            cache = _cache_from_stacked(cache, cfg)
        return serve(as_port(params), cache, token, pos)
    return decode, (params, cache, batch["token"], batch["pos"]), meta


def build_model(arch: str, smoke: bool = False):
    """Public convenience: (cfg, step-function bundle)."""
    cfg = get_config(arch, smoke=smoke)
    init_state, train_step = make_train_step(cfg)
    return cfg, {
        "init_state": init_state,
        "train_step": train_step,
        "prefill": make_prefill_step(cfg, max_len=4096),
        "serve_step": make_serve_step(cfg),
    }
