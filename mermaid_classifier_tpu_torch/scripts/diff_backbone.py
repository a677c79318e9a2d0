"""Layer-by-layer activation diff: a torch EfficientNet checkpoint run as
it is (the canonical mirror, ``models/canonical_mirror.py``) against the
port's ``EfficientNetBackbone`` after the remap and the conversion, both on
``--device`` in f32 with TF32 off.

The landing strip for the production weights (``efficientnet.pt``): one
command answers "do these weights reproduce in the port, and if not, which
layer diverges first". Usage:

    python -m mermaid_classifier_tpu_torch.scripts.diff_backbone weights.pt \\
        [--save-npz backbone.npz --record fidelity.json] [--device cuda]
    python -m mermaid_classifier_tpu_torch.scripts.diff_backbone --self-test

It reads torchvision naming, lukemelas / EfficientNet-PyTorch naming (the
pyspacer lineage, also as the ``{'net': {'module.<key>': ...}}`` checkpoint
dict CoralNet saves) or the canonical naming, detected by the keys
(``--dump-remap`` writes the table). Every stem, block, sub-layer, head and
projection activation of a seeded probe batch is compared through an
explicit table pairing the mirror's modules with the port's; a layer
either side leaves unpaired fails the run. Per-layer max|delta| is held to
``--layer-tol`` and the final-feature MAE to ``--feature-tol`` (the 1e-4
contract). ``--save-npz`` writes the converted bundle with its config
sidecar, and ``--record`` the fidelity record that ``release_artifact``
requires before it ships backbone weights. Exit 0 only when every row is
green. The default ``--device cuda`` raises without a card.
"""

from __future__ import annotations

import argparse
import sys

RECORD_COMMAND = "python -m mermaid_classifier_tpu_torch.scripts.diff_backbone"


def load_state_dict(path: str):
    """A torch ``.pt`` (plain state_dict, a ``{'state_dict': ...}`` or
    ``{'net': ...}`` dict, or a scripted module) or a flat ``.npz``."""
    if path.endswith(".npz"):
        import numpy as np

        with np.load(path, allow_pickle=False) as archive:
            return {k: archive[k] for k in archive.files}
    import torch

    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        payload = torch.jit.load(path, map_location="cpu").state_dict()
    if hasattr(payload, "state_dict"):
        payload = payload.state_dict()
    if isinstance(payload, dict) and "state_dict" in payload:
        payload = payload["state_dict"]
    # The production efficientnet.pt is CoralNet's DataParallel checkpoint
    # dict: the state_dict under 'net', every key 'module.'-prefixed
    # (models.remap.strip_module_prefix drops the prefix).
    if isinstance(payload, dict) and "net" in payload and isinstance(
        payload["net"], dict
    ):
        payload = payload["net"]
    return payload


def layer_pairs(config) -> list[tuple[str, str]]:
    """(mirror module, port module) for every layer both networks run, stem
    to projection. The names agree module for module, except that the
    port's forward applies the projection's weights with ``F.linear`` (its
    ``feature_projection`` module is never called), so the projection's
    port side is the forward's output, ``""``."""

    def cba(prefix):
        return [prefix, f"{prefix}.conv", f"{prefix}.bn"]

    names = cba("stem")
    for stage_idx, (expand, _out, repeats, _stride, _kernel) in enumerate(
        config.stages
    ):
        for block_idx in range(repeats):
            block = f"stage{stage_idx}_block{block_idx}"
            names.append(block)
            if expand != 1:
                names += cba(f"{block}.expand")
            names += cba(f"{block}.depthwise")
            names += [f"{block}.se", f"{block}.se.reduce", f"{block}.se.expand"]
            names += cba(f"{block}.project")
    names += cba("head")
    pairs = [(n, n) for n in names]
    if config.feature_dim != config.head_channels:
        pairs.append(("feature_projection", ""))
    return pairs


def _capture(model, x, names):
    """{module name: output as a host f32 array} for ``names`` plus ``""``,
    the forward's output."""
    import torch

    acts = {}
    modules = dict(model.named_modules())

    def hook_for(name):
        def hook(_mod, _inp, out):
            acts[name] = out.detach().float().cpu().numpy()
        return hook

    handles = [modules[n].register_forward_hook(hook_for(n))
               for n in names if n and n in modules]
    try:
        with torch.no_grad():
            acts[""] = model(x).float().cpu().numpy()
    finally:
        for h in handles:
            h.remove()
    return acts


def diff_rows(mirror_acts, port_acts, pairs):
    """(layer, max|delta| or None, problem or None) per pair. Both networks
    run NCHW inside (the port takes NHWC at its input only), so the maps
    compare as they are."""
    import numpy as np

    rows = []
    for mirror_name, port_name in pairs:
        if mirror_name not in mirror_acts or port_name not in port_acts:
            side = "mirror" if mirror_name not in mirror_acts else "port"
            rows.append((mirror_name, None, f"unpaired: no {side} activation"))
            continue
        t, f = mirror_acts[mirror_name], port_acts[port_name]
        if t.shape != f.shape:
            rows.append((mirror_name, None, f"shape {t.shape} vs {f.shape}"))
            continue
        rows.append((mirror_name, float(np.max(np.abs(t - f))), None))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("weights", nargs="?", default=None,
                        help=".pt/.npz checkpoint; omit with --self-test")
    parser.add_argument("--self-test", action="store_true",
                        help="diff the seeded canonical mirror instead of a"
                        " file (proves the harness end to end)")
    parser.add_argument("--feature-dim", type=int, default=None,
                        help="override feature_dim (e.g. 1280 for a raw"
                        " torchvision checkpoint with no 4096 projection)")
    parser.add_argument("--padding", choices=("auto", "symmetric", "tf_same"),
                        default="auto",
                        help="conv padding; 'auto' picks tf_same for"
                        " lukemelas-named checkpoints (the pyspacer lineage"
                        " pads TF-SAME, asymmetric at stride 2) and symmetric"
                        " otherwise")
    parser.add_argument("--bn-eps", type=float, default=None,
                        help="BatchNorm epsilon override (lukemelas/TF"
                        " lineage: 1e-3, the default; raw torchvision"
                        " checkpoints: 1e-5)")
    parser.add_argument("--config-json", default=None,
                        help="EfficientNetConfig.to_dict() JSON overriding"
                        " the production B0 geometry")
    parser.add_argument("--probe-batch", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--feature-tol", type=float, default=1e-4,
                        help="final-feature MAE gate")
    parser.add_argument("--layer-tol", type=float, default=5e-4,
                        help="per-layer max|delta| gate")
    parser.add_argument("--dump-remap", default=None,
                        help="write the applied old->new key table as CSV")
    parser.add_argument("--save-npz", default=None,
                        help="when all is green, write the converted weights"
                        " as a pickle-free npz and its .config.json sidecar"
                        " (padding and bn_eps travel with the weights)")
    parser.add_argument("--record", default=None,
                        help="write the fidelity record JSON here: the proof"
                        " release_artifact requires before it ships backbone"
                        " weights")
    parser.add_argument("--device", default="cuda",
                        help="torch device both sides run on (default cuda)")
    args = parser.parse_args(argv)

    import dataclasses
    import json

    import numpy as np
    import torch

    from mermaid_classifier_tpu_torch.models.canonical_mirror import (
        CanonicalMirror,
        randomize_bn_stats,
    )
    from mermaid_classifier_tpu_torch.models.convert import (
        backbone_sidecar_path,
        save_backbone_npz,
        torch_state_dict_to_variables,
    )
    from mermaid_classifier_tpu_torch.models.efficientnet import (
        EfficientNetBackbone,
        EfficientNetConfig,
        load_jax_variables,
    )
    from mermaid_classifier_tpu_torch.models.extractor import _resolve_device
    from mermaid_classifier_tpu_torch.models.remap import (
        detect_naming_scheme,
        remap_state_dict,
        strip_module_prefix,
    )
    from mermaid_classifier_tpu_torch.ops.fused_mbconv import full_f32

    device = _resolve_device(args.device)
    if args.config_json:
        with open(args.config_json) as f:
            config_dict = json.load(f)
        if args.feature_dim:
            config_dict["feature_dim"] = args.feature_dim
        config = EfficientNetConfig.from_dict(config_dict)
    else:
        config = EfficientNetConfig(
            feature_dim=args.feature_dim or EfficientNetConfig().feature_dim
        )

    if args.self_test:
        torch.manual_seed(args.seed)
        mirror = CanonicalMirror(config)
        randomize_bn_stats(mirror, seed=args.seed)
        state_dict = mirror.state_dict()
        print("self-test: seeded canonical mirror (canonical naming)")
    else:
        if not args.weights:
            parser.error("provide a weights file or --self-test")
        state_dict = load_state_dict(args.weights)

    stripped = strip_module_prefix(state_dict)
    scheme = detect_naming_scheme(stripped)

    overrides = {}
    if args.padding == "auto":
        # pyspacer-lineage (lukemelas-named) checkpoints were trained with
        # TF-SAME padding; the symmetric graph fails the 1e-4 gate at every
        # stride-2 layer.
        if scheme == "lukemelas":
            overrides["padding"] = "tf_same"
    else:
        overrides["padding"] = args.padding
    if args.bn_eps is not None:
        overrides["bn_eps"] = args.bn_eps
    if overrides:
        config = dataclasses.replace(config, **overrides)
    print(f"padding={config.padding}, bn_eps={config.bn_eps:g}")

    canonical, applied, dropped = remap_state_dict(stripped, config, scheme)
    print(f"naming scheme: {scheme}; {len(applied)} keys mapped,"
          f" {len(dropped)} dropped ({sorted(dropped)[:3]}...)"
          if dropped else
          f"naming scheme: {scheme}; {len(applied)} keys mapped, 0 dropped")
    if args.dump_remap:
        with open(args.dump_remap, "w") as f:
            f.write("source_key,canonical_key\n")
            for old, new in sorted(applied.items()):
                f.write(f"{old},{new}\n")
        print(f"remap table -> {args.dump_remap}")

    variables = torch_state_dict_to_variables(canonical, config)
    print("conversion: OK (all keys consumed, shapes verified)")

    mirror = CanonicalMirror(config)
    mirror.load_state_dict(
        {k: torch.as_tensor(np.asarray(
            v.detach().cpu() if isinstance(v, torch.Tensor) else v,
            dtype=np.float32))
         for k, v in canonical.items()
         if not k.endswith("num_batches_tracked")},
        strict=False,
    )
    mirror = mirror.to(device).eval()
    port = EfficientNetBackbone(config)
    load_jax_variables(port, variables)
    port = port.to(device).eval()

    rng = np.random.default_rng(args.seed)
    ps = config.patch_size
    probe_nhwc = rng.normal(size=(args.probe_batch, ps, ps, 3)).astype(np.float32)
    probe_nchw = np.transpose(probe_nhwc, (0, 3, 1, 2)).copy()

    pairs = layer_pairs(config)
    mirror_names = {n for n, _ in mirror.named_modules() if n}
    port_names = {n for n, _ in port.named_modules() if n}
    unpaired = sorted((mirror_names - {m for m, _ in pairs})
                      | (port_names - {p for _, p in pairs}
                         - {"feature_projection"}))
    with full_f32():
        mirror_acts = _capture(
            mirror, torch.from_numpy(probe_nchw).to(device), [m for m, _ in pairs])
        port_acts = _capture(
            port, torch.from_numpy(probe_nhwc).to(device), [p for _, p in pairs])
    rows = diff_rows(mirror_acts, port_acts, pairs)
    rows += [(name, None, "unpaired: not in the pairing table")
             for name in unpaired]

    n_fail = 0
    worst = 0.0
    print(f"\n{'layer':44s} {'max|Δ|':>12s}  status")
    for path, max_abs, problem in rows:
        if problem:
            print(f"{path:44s} {'—':>12s}  FAIL ({problem})")
            n_fail += 1
        else:
            worst = max(worst, max_abs)
            ok = max_abs <= args.layer_tol
            n_fail += 0 if ok else 1
            print(f"{path:44s} {max_abs:12.3e}  {'ok' if ok else 'FAIL'}")

    feature_mae = float(np.mean(np.abs(mirror_acts[""] - port_acts[""])))
    feature_ok = feature_mae <= args.feature_tol
    print(f"\nfinal feature MAE: {feature_mae:.3e}"
          f" (gate {args.feature_tol:.0e}) -> {'ok' if feature_ok else 'FAIL'}")
    if not feature_ok:
        n_fail += 1

    all_green = n_fail == 0
    if args.save_npz and all_green:
        save_backbone_npz(args.save_npz, variables, config)
        print(f"saved: {args.save_npz} + {backbone_sidecar_path(args.save_npz)}")
    if args.record:
        # The record hashes the file the release will ship: the converted
        # npz when one was saved, else the input checkpoint.
        import hashlib
        from datetime import datetime, timezone

        hashed = args.save_npz if (args.save_npz and all_green) else args.weights
        sha = None
        if hashed:
            h = hashlib.sha256()
            with open(hashed, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            sha = h.hexdigest()
        record = {
            "all_green": all_green,
            "n_layers_compared": len(rows),
            "n_layers_failed": n_fail,
            "feature_mae": feature_mae,
            "feature_tol": args.feature_tol,
            "layer_tol": args.layer_tol,
            "worst_layer_max_abs": worst,
            "padding": config.padding,
            "bn_eps": config.bn_eps,
            "naming_scheme": scheme,
            "weights_file": hashed,
            "weights_sha256": sha,
            "probe_batch": args.probe_batch,
            "seed": args.seed,
            "timestamp_utc": datetime.now(timezone.utc).isoformat(),
            "command": " ".join(
                [RECORD_COMMAND, *(sys.argv[1:] if argv is None else argv)]),
        }
        with open(args.record, "w") as f:
            json.dump(record, f, indent=1)
        print(f"fidelity record -> {args.record} (all_green={all_green})")

    if n_fail:
        print(f"\n{n_fail} layer(s) diverge — fix the FIRST failing layer;"
              " everything after it inherits the error.")
        return 1
    print(f"\nALL GREEN: {len(rows)} layers within {args.layer_tol:.0e},"
          f" features within {args.feature_tol:.0e} on {device}.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
