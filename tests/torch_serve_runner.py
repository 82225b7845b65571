"""Serves an exported program in a process that imports only torch,
numpy and `adanet_tpu_torch.ops` (which registers the kernels' custom
ops), as a serving host with no model code would.

    python tests/torch_serve_runner.py EXPORT_DIR REQUESTS.npz OUT.npz DEVICE

REQUESTS.npz holds `<i>/<feature>` arrays, one request a prefix `<i>`;
OUT.npz gets `<i>/<output>` (a nested output `<i>/<key>/<inner>`),
`__modules__`, the port's modules this process imported, and
`__launches__`, K1's launches in this process.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import adanet_tpu_torch.ops  # noqa: E402,F401  (registers the custom ops)


def _flat(prefix, tree, out):
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flat(prefix + "/" + key, value, out)
    else:
        out[prefix] = tree.detach().cpu().numpy()


def main(argv):
    export_dir, requests, out_path, device = argv[:4]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    program = torch.export.load(os.path.join(export_dir, "serving.pt2")).module()
    data = np.load(requests)
    batches = {}
    for key in data.files:
        index, name = key.split("/", 1)
        batches.setdefault(int(index), {})[name] = data[key]
    out = {}
    for index in sorted(batches):
        features = {k: torch.from_numpy(v).to(device) for k, v in sorted(batches[index].items())}
        with torch.inference_mode():
            _flat(str(index), program(features), out)
    out["__modules__"] = np.array(sorted(m for m in sys.modules if m.startswith("adanet_tpu_torch")))
    out["__launches__"] = np.array(adanet_tpu_torch.ops.ensemble_kernels.fused_weighted_combine.launches)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
