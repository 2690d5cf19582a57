"""Checkpoint helpers around a saved directory: discovery, integrity
validation, quarantine, retention GC and auto-resume with fallback.

Counterpart of ``paddlefleetx_tpu/utils/checkpoint.py`` (``corrupt_rename``,
``_step_dirs``, ``validate_checkpoint``, ``quarantine_checkpoint``,
``latest_checkpoint``, ``gc_checkpoints``, ``resume_with_fallback``),
applied to the port's own format, which ``core/engine.Engine.save``
writes::

    <output_dir>/step_<N>/state.pt     params + optimizer state (torch.save),
                                       written first, atomically
    <output_dir>/step_<N>/meta.json    step, consumed_samples, loader state,
                                       preempted: written last, atomically,
                                       so it marks a complete checkpoint

Validity has two tiers, as in the JAX package: **structural**
(:func:`validate_checkpoint`: a parseable ``meta.json`` and a non-empty
payload) and **restorability** (only a load proves the bytes: the
engine's ``load`` raises :class:`CorruptCheckpoint` on a payload it
cannot read, and :func:`resume_with_fallback` quarantines that directory
and falls back to the previous one).

Params for serving and warm starts (JAX ``restore_params`` :288,
``load_pretrained_params`` :345, ``save_params_checkpoint`` :353) come
from either of the port's layouts: a step directory above (only its
``"params"`` are read: the file is memory-mapped, so the optimizer
moments, about twice the param bytes, never land in memory) or a
params-only directory, the contract of the JAX HF import tools::

    <dir>/params.pt     the named float32 params (torch.save)
    <dir>/meta.json     {"format": "params-only", "source": ...}
    <dir>/model.yaml    the matching Model config block

:func:`load_params_into` copies them into a model, cast to each
parameter's dtype as ``models/gpt/bridge.py`` casts, after checking every
name and shape.  Differences from JAX: an unreadable payload raises
:class:`CorruptCheckpoint` naming the directory and leaves it where it is
(no quarantine rename of a directory a server was pointed at); reading
the JAX package's orbax checkpoints is not ported.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from paddlefleetx_tpu_torch.utils.log import logger

CORRUPT_SUFFIX = ".corrupt"
PAYLOAD = "state.pt"
META = "meta.json"
PARAMS = "params.pt"


class CorruptCheckpoint(ValueError):
    """A checkpoint directory whose payload or meta cannot be read: bad
    bytes in that directory, which quarantine may rename away."""


def corrupt_rename(path: str) -> Optional[str]:
    """Rename ``path`` to the first free ``*.corrupt[.N]`` name (the
    quarantine convention shared with the index-map caches); returns the
    new path, or None when another process already renamed or removed
    it."""
    path = os.path.abspath(path.rstrip("/"))
    dst = path + CORRUPT_SUFFIX
    n = 1
    while os.path.exists(dst):
        dst = f"{path}{CORRUPT_SUFFIX}.{n}"
        n += 1
    try:
        os.rename(path, dst)
    except FileNotFoundError:
        return None
    return dst


def _step_dirs(output_dir: str) -> List[Tuple[int, str]]:
    """(step, path) for every ``step_N`` dir with a parseable meta.json,
    newest first.  Dirs without one are crashed or in-flight saves:
    skipped, never quarantined."""
    found: List[Tuple[int, str]] = []
    if not os.path.isdir(output_dir):
        return found
    for name in os.listdir(output_dir):
        if not name.startswith("step_") or CORRUPT_SUFFIX in name:
            continue
        path = os.path.join(output_dir, name)
        try:
            step = int(name[len("step_"):])
            with open(os.path.join(path, META)) as f:
                json.load(f)
        except (ValueError, OSError):
            continue
        found.append((step, path))
    found.sort(reverse=True)
    return found


def validate_checkpoint(path: str) -> Optional[str]:
    """Structural integrity check; None when OK, else the reason."""
    try:
        with open(os.path.join(path, META)) as f:
            json.load(f)
    except (OSError, ValueError) as e:
        return f"{META} missing/unparseable ({e})"
    payload = os.path.join(path, PAYLOAD)
    if not os.path.isfile(payload):
        return f"no {PAYLOAD} payload"
    if os.path.getsize(payload) == 0:
        return f"{PAYLOAD} is empty"
    return None


def quarantine_checkpoint(path: str) -> str:
    """Rename a corrupt checkpoint dir to ``<path>.corrupt`` (``.N`` when
    colliding) so resume cannot pick it again; returns the new path."""
    dst = corrupt_rename(path)
    if dst is None:
        logger.warning(f"quarantine of {path}: already renamed/removed by another "
                       "process; continuing")
        return os.path.abspath(path.rstrip("/")) + CORRUPT_SUFFIX
    logger.error(f"QUARANTINED corrupt checkpoint: {path} -> {dst} (inspect or delete "
                 "manually; resume falls back to the previous good checkpoint)")
    return dst


class QuarantineBudget:
    """A shared cap on the directories one resume attempt may quarantine,
    across the structural walk and restore failures."""

    def __init__(self, remaining: int) -> None:
        self.remaining = int(remaining)

    def spend(self, path: str, reason: str, output_dir: str) -> None:
        if self.remaining <= 0:
            raise RuntimeError(
                f"quarantine budget exhausted under {output_dir} and {path} failed too "
                f"({reason}): this is systemic (storage, config mismatch), not "
                "per-checkpoint corruption; refusing to quarantine further"
            )
        quarantine_checkpoint(path)
        self.remaining -= 1


def latest_checkpoint(output_dir: str, validate: bool = True, quarantine: bool = True,
                      max_quarantines: int = 3,
                      budget: Optional[QuarantineBudget] = None) -> Optional[str]:
    """Newest structurally valid ``step_N`` dir (None if none); a broken
    newest one is quarantined (when ``quarantine``) and the walk falls
    back to the next older one, at most ``max_quarantines`` times."""
    budget = budget if budget is not None else QuarantineBudget(max_quarantines)
    for _step, path in _step_dirs(output_dir):
        if not validate:
            return path
        reason = validate_checkpoint(path)
        if reason is None:
            return path
        logger.error(f"checkpoint {path} failed validation: {reason}")
        if quarantine:
            budget.spend(path, reason, output_dir)
    return None


def gc_checkpoints(output_dir: str, keep_last_n: int,
                   protect: Optional[str] = None) -> List[str]:
    """Delete all but the newest ``keep_last_n`` valid ``step_N`` dirs;
    ``protect`` (the rollback target) is never deleted and invalid dirs do
    not count toward the quota.  Returns the removed paths."""
    if keep_last_n <= 0:
        return []
    protect_abs = os.path.abspath(protect) if protect else None
    kept = 0
    removed: List[str] = []
    for _step, path in _step_dirs(output_dir):
        if validate_checkpoint(path) is not None:
            continue
        if kept < keep_last_n or os.path.abspath(path) == protect_abs:
            kept += 1
            continue
        shutil.rmtree(path)
        removed.append(path)
        logger.info(f"retention GC (keep_last_n={keep_last_n}): removed {path}")
    return removed


def is_corruption_error(e: BaseException) -> bool:
    """True when a load failure shows bad bytes in that directory (a
    quarantine is warranted), not a systemic problem such as a model
    config that does not match the checkpoint."""
    return isinstance(e, (CorruptCheckpoint, json.JSONDecodeError))


def resume_with_fallback(engine, output_dir: str, max_quarantines: int = 3) -> Optional[str]:
    """auto_resume: load the newest valid checkpoint into ``engine``,
    quarantining any whose load fails with a corruption error and falling
    back to the next older one.  Returns the path that loaded, or None
    when no checkpoint exists."""
    budget = QuarantineBudget(max_quarantines)
    while True:
        path = latest_checkpoint(output_dir, budget=budget)
        if path is None:
            return None
        logger.info(f"auto_resume: found {path}")
        try:
            engine.load(path)
            return path
        except Exception as e:  # noqa: BLE001 — classified right below
            if not is_corruption_error(e):
                raise
            logger.error(f"auto_resume: checkpoint {path} failed to load ({e}); "
                         "quarantining and falling back")
            budget.spend(path, str(e), output_dir)


def restore_params(ckpt_dir: str) -> Dict[str, torch.Tensor]:
    """The named float32 params (CPU tensors) of a step directory
    (``state.pt``'s ``"params"``, memory-mapped) or of a params-only
    directory (``params.pt``).  Unreadable bytes raise
    :class:`CorruptCheckpoint`; a directory with neither file raises
    ``FileNotFoundError``."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    params_only = os.path.join(ckpt_dir, PARAMS)
    payload = os.path.join(ckpt_dir, PAYLOAD)
    path = params_only if os.path.isfile(params_only) else payload
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{ckpt_dir}: neither {PARAMS} (params-only) nor {PAYLOAD} "
                                "(a training step) found")
    try:
        loaded = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
        params = loaded if path == params_only else loaded["params"]
    except (RuntimeError, EOFError, pickle.UnpicklingError, ValueError, KeyError,
            TypeError) as e:
        raise CorruptCheckpoint(f"checkpoint {ckpt_dir} unreadable: {e}") from e
    if not isinstance(params, dict) or not all(
            isinstance(k, str) and isinstance(v, torch.Tensor) for k, v in params.items()):
        raise CorruptCheckpoint(f"checkpoint {ckpt_dir}: {os.path.basename(path)} holds no "
                                "named params")
    return params


def load_pretrained_params(cfg) -> Optional[Dict[str, torch.Tensor]]:
    """Params from ``Engine.save_load.ckpt_dir`` (None when unset)."""
    save_load = (cfg.get("Engine", {}) or {}).get("save_load", {}) or {}
    ckpt_dir = save_load.get("ckpt_dir")
    if not ckpt_dir:
        return None
    return restore_params(ckpt_dir)


@torch.no_grad()
def load_params_into(model: torch.nn.Module, params: Dict[str, torch.Tensor],
                     source: str) -> torch.nn.Module:
    """Copy ``params`` into ``model``'s parameters of the same names, each
    cast to the parameter's dtype: bf16 and float16 serving weights round to
    nearest from a step's float32 masters, as the bridge rounds them and as
    the JAX server's ``astype`` casts its params (a float16 overflow is
    inf); LayerNorm affines stay float32.  A checkpoint of
    another config raises ``ValueError`` naming the first mismatched
    parameter, before anything is copied."""
    own = dict(model.named_parameters())
    for name, p in own.items():
        if name not in params:
            raise ValueError(f"{source}: the model's parameter {name} is missing from the "
                             "checkpoint (a different Model config?)")
        if tuple(params[name].shape) != tuple(p.shape):
            raise ValueError(f"{source}: {name}: model {tuple(p.shape)} vs checkpoint "
                             f"{tuple(params[name].shape)} (hint: --pad-vocab-to in "
                             "tools/convert_hf_gpt2.py must match Model.vocab_size)")
    extra = [n for n in params if n not in own]
    if extra:
        raise ValueError(f"{source}: the checkpoint's parameter {extra[0]} is not in the "
                         f"model ({len(extra)} extra; a different Model config?)")
    for name, p in own.items():
        p.copy_(params[name])
    return model


def save_params_checkpoint(out_dir: str, params: Dict[str, torch.Tensor], source: str,
                           model_fields: dict) -> str:
    """Write the params-only directory: ``params.pt`` (the named params as
    float32 CPU tensors, written to a temporary name and renamed into
    place), ``meta.json`` (format and source) and ``model.yaml`` (the
    matching Model config block).  Returns the directory."""
    out = os.path.abspath(out_dir)
    os.makedirs(out, exist_ok=True)
    tensors = {n: t.detach().to("cpu", torch.float32).contiguous() for n, t in params.items()}
    tmp = os.path.join(out, f"{PARAMS}.tmp{os.getpid()}")
    torch.save(tensors, tmp)
    os.replace(tmp, os.path.join(out, PARAMS))
    with open(os.path.join(out, META), "w") as f:
        json.dump({"format": "params-only", "source": source}, f)
    with open(os.path.join(out, "model.yaml"), "w") as f:
        f.write("Model:\n")
        for k, v in model_fields.items():
            if isinstance(v, float):
                # YAML 1.1 reads "1e-12" as a STRING; force a float form
                text = repr(v)
                if "e" in text and "." not in text.split("e")[0]:
                    mant, exp = text.split("e")
                    text = f"{mant}.0e{exp}"
                v = text
            f.write(f"  {k}: {v}\n")
    return out
