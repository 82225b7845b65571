"""Serving export: the port's own generation format.

The JAX package serializes a StableHLO program (`serving.stablehlo`),
which cannot be read without jax. The port instead writes, under one
export directory:

    architecture.json        the winning ensemble's `Architecture`
    params.npz               every member's port-layout state dict and the
                             ensembler's weights and bias, as numpy
    serving_signature.json   how to rebuild the program: each member's
                             builder spec, the ensembler and head specs,
                             and the feature signature

No pickle and no msgpack: `np.load(..., allow_pickle=False)` and JSON
are all a loader needs. `load_serving_program(export_dir, device)`
rebuilds `features -> predictions` (member forwards, the mixture
combine, the head's predictions), the counterpart of the JAX package's
`Estimator._frozen_predict_fn`. A mean ensemble exports no weights; a
multi-head (dict) program is not exported yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict

import numpy as np
import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.core.architecture import Architecture
from adanet_tpu_torch.core.frozen import (
    FrozenEnsemble,
    FrozenSubnetwork,
    FrozenWeightedSubnetwork,
)
from adanet_tpu_torch.core.heads import head_from_spec
from adanet_tpu_torch.ensemble import ensembler_from_spec

FORMAT = "adanet_tpu_torch/1"
ARCHITECTURE_FILE = "architecture.json"
PARAMS_FILE = "params.npz"
SIGNATURE_FILE = "serving_signature.json"
REQUIRED_SERVING_FILES = (PARAMS_FILE, SIGNATURE_FILE, ARCHITECTURE_FILE)


def builder_from_spec(spec: Dict[str, Any]):
    """Rebuilds a builder from its `to_spec()`."""
    from adanet_tpu_torch.research.improve_nas import improve_nas

    kinds = {improve_nas.KIND: improve_nas.Builder.from_spec}
    if spec.get("kind") not in kinds:
        raise ValueError("builder kind %r is not ported yet" % (spec.get("kind"),))
    return kinds[spec["kind"]](spec)


def _numpy(value) -> np.ndarray:
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def feature_signature(sample_features) -> Dict[str, Any]:
    """`{"shape": ["batch", ...], "dtype": ...}` per feature leaf, with the
    batch dimension symbolic, as the JAX export's signature writes it."""

    def leaf(x):
        arr = _numpy(x)
        return {
            "shape": ["batch"] + [str(d) for d in arr.shape[1:]],
            "dtype": str(arr.dtype),
        }

    if isinstance(sample_features, dict):
        return {k: feature_signature(v) for k, v in sample_features.items()}
    return leaf(sample_features)


def _example_shape(inputs: Dict[str, Any]):
    leaves = []

    def walk(node):
        if set(node) == {"shape", "dtype"}:
            leaves.append(node)
        else:
            for key in sorted(node):
                walk(node[key])

    walk(inputs)
    if len(leaves) != 1:
        raise ValueError("serving export expects one feature leaf, got %d" % len(leaves))
    return tuple(int(d) for d in leaves[0]["shape"][1:])


def export_serving_program(
    export_dir: str,
    frozen: FrozenEnsemble,
    ensembler,
    head,
    sample_features,
) -> str:
    """Writes the generation files of `frozen` into `export_dir`; returns
    the params path."""
    members = []
    arrays: Dict[str, np.ndarray] = {}
    for i, ws in enumerate(frozen.weighted_subnetworks):
        sub = ws.subnetwork
        if sub.builder_spec is None:
            raise ValueError("member %s has no builder spec to rebuild it from" % sub.name)
        members.append(
            {
                "name": sub.name,
                "iteration_number": int(sub.iteration_number),
                "complexity": float(sub.complexity),
                "shared": sub.shared,
                "builder": sub.builder_spec,
            }
        )
        for key, value in sub.module.state_dict().items():
            arrays["member_%d/%s" % (i, key)] = _numpy(value)
    params = frozen.ensembler_params or {}
    if any(isinstance(w, dict) for w in params.get("weights", [])) or isinstance(params.get("bias"), dict):
        raise NotImplementedError("multi-head serving export is not ported yet")
    for j, weight in enumerate(params.get("weights", [])):
        arrays["ensembler/weights/%d" % j] = _numpy(weight).astype(np.float32)
    if params.get("bias") is not None:
        arrays["ensembler/bias"] = _numpy(params["bias"]).astype(np.float32)
    signature = {
        "format": FORMAT,
        "name": frozen.name,
        "iteration_number": int(frozen.iteration_number),
        "members": members,
        "ensembler_name": frozen.ensembler_name,
        "ensembler": ensembler.to_spec(),
        "head": head.to_spec(),
        "inputs": feature_signature(sample_features),
    }
    os.makedirs(export_dir, exist_ok=True)
    with open(os.path.join(export_dir, ARCHITECTURE_FILE), "w") as f:
        f.write(frozen.architecture.serialize())
    path = os.path.join(export_dir, PARAMS_FILE)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with open(os.path.join(export_dir, SIGNATURE_FILE), "w") as f:
        json.dump(signature, f, indent=2, sort_keys=True)
    return path


def serving_signature(export_dir: str) -> Dict[str, Any]:
    with open(os.path.join(export_dir, SIGNATURE_FILE)) as f:
        return json.load(f)


def _to_device(features, device: torch.device):
    if isinstance(features, dict):
        return {k: _to_device(v, device) for k, v in features.items()}
    if torch.is_tensor(features):
        return features.to(device)
    return torch.from_numpy(np.ascontiguousarray(features)).to(device)


def load_frozen_ensemble(
    export_dir: str, device="cuda", compute_dtype=None
) -> FrozenEnsemble:
    """Rebuilds the frozen ensemble of a generation on `device`.

    `compute_dtype` overrides every member's compute dtype (e.g. float32
    to compare a bf16 generation across devices at full precision).
    """
    dev = resolve_device(device)
    sig = serving_signature(export_dir)
    if sig.get("format") != FORMAT:
        raise ValueError("unknown serving format %r" % (sig.get("format"),))
    with np.load(os.path.join(export_dir, PARAMS_FILE), allow_pickle=False) as npz:
        arrays = {key: npz[key] for key in npz.files}
    with open(os.path.join(export_dir, ARCHITECTURE_FILE)) as f:
        architecture = Architecture.deserialize(f.read())
    head = head_from_spec(sig["head"])
    input_shape = _example_shape(sig["inputs"])
    weighted = []
    for i, member in enumerate(sig["members"]):
        spec = member["builder"]
        if compute_dtype is not None:
            from adanet_tpu_torch.research.improve_nas.improve_nas import dtype_name

            spec = dict(spec, hparams=dict(spec["hparams"], compute_dtype=dtype_name(compute_dtype)))
        module = builder_from_spec(spec).build_subnetwork(
            head.logits_dimension, input_shape=input_shape
        )
        prefix = "member_%d/" % i
        state = {
            key[len(prefix):]: torch.from_numpy(value)
            for key, value in arrays.items()
            if key.startswith(prefix)
        }
        module.load_state_dict(state, strict=True)
        module.to(dev).eval()
        weighted.append(
            FrozenWeightedSubnetwork(
                subnetwork=FrozenSubnetwork(
                    iteration_number=member["iteration_number"],
                    name=member["name"],
                    module=module,
                    complexity=member["complexity"],
                    shared=member["shared"],
                    builder_spec=spec,
                )
            )
        )
    n = len(weighted)
    params = {}
    if "ensembler/weights/0" in arrays:
        params = {
            "weights": [torch.from_numpy(arrays["ensembler/weights/%d" % j]).to(dev) for j in range(n)],
            "bias": (
                torch.from_numpy(arrays["ensembler/bias"]).to(dev)
                if "ensembler/bias" in arrays
                else None
            ),
        }
        for ws, weight in zip(weighted, params["weights"]):
            ws.weight = weight
    return FrozenEnsemble(
        name=sig["name"],
        iteration_number=sig["iteration_number"],
        weighted_subnetworks=weighted,
        ensembler_name=sig["ensembler_name"],
        ensembler_params=params,
        architecture=architecture,
    )


def load_serving_program(
    export_dir: str, device="cuda", compute_dtype=None
) -> Callable:
    """Loads a generation; returns `fn(features) -> predictions` (a dict
    of tensors on `device`). On a CUDA device the kernels' self-test (K0)
    runs first, the counterpart of the JAX package's lowering probe in
    front of its Pallas kernels."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from adanet_tpu_torch.ops import _build

        _build.self_test(dev)
    sig = serving_signature(export_dir)
    frozen = load_frozen_ensemble(export_dir, dev, compute_dtype)
    ensembler = ensembler_from_spec(sig["ensembler"])
    head = head_from_spec(sig["head"])

    def predict(features):
        features = _to_device(features, dev)
        with torch.inference_mode():
            outs = frozen.member_outputs(features, training=False)
            ensemble = ensembler.build_ensemble(frozen.ensembler_params, outs)
            return head.predictions(ensemble.logits)

    return predict
