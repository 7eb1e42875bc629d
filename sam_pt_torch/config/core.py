"""Hydra-compatible configuration system (counterpart of
`sam_pt_tpu/config/core.py`; no hydra, omegaconf or PyYAML).

The reference composes every model object from a Hydra YAML tree with
`defaults:` lists, `_target_` instantiation, `${...}` interpolation and CLI
dotted overrides (reference configs/vos_eval_root.yaml, SURVEY.md §2.8). This
module reimplements the subset of Hydra 1.3 semantics that the reference
configs rely on, so reference-style commands keep working:

  - defaults lists:  `- point_tracker: cotracker`, `- sam@path.to.key: name`,
    `- _self_`, `- base_config` and group overrides from the CLI
    (`model/point_tracker=pips`).
  - interpolation:  `${a.b.c}` absolute references, `${hydra:runtime.cwd}`.
  - instantiate:  recursive `_target_` object construction.
  - CLI overrides:  `a.b=3`, `+a.new=4`, typed scalar parsing.

YAML files and override values are read by `miniyaml`, the port's reader
for the subset its configs use, on every machine: where PyYAML is
installed too, it is not used.
"""
from __future__ import annotations

import importlib
import os
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from . import miniyaml

Config = Dict[str, Any]

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


# ---------------------------------------------------------------------------
# YAML loading and defaults-list composition
# ---------------------------------------------------------------------------

def load_yaml(path: Union[str, Path]) -> Config:
    data = miniyaml.load_file(path)
    return data if data is not None else {}


def _deep_merge(base: Any, override: Any) -> Any:
    """Merge override into base, dicts recursively, other types replace."""
    if isinstance(base, dict) and isinstance(override, dict):
        out = dict(base)
        for k, v in override.items():
            out[k] = _deep_merge(out[k], v) if k in out else v
        return out
    return override


def _set_path(cfg: Config, dotted: str, value: Any, *, allow_new: bool = True) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            if not allow_new:
                raise KeyError(f"Config path not found: {dotted}")
            node[k] = {}
        node = node[k]
    last = keys[-1]
    if not allow_new and last not in node:
        raise KeyError(f"Config path not found: {dotted} (use +{dotted}= to add)")
    if last in node:
        node[last] = _deep_merge(node[last], value)
    else:
        node[last] = value


def _get_path(cfg: Config, dotted: str) -> Any:
    node: Any = cfg
    for k in dotted.split("."):
        if isinstance(node, dict):
            node = node[k]
        elif isinstance(node, (list, tuple)):
            node = node[int(k)]
        else:
            raise KeyError(dotted)
    return node


def _parse_default_entry(entry: Any) -> Optional[tuple]:
    """Parse one defaults-list entry -> (group, name, package, explicit_pkg)
    or None for _self_. `explicit_pkg` is True for the `group@pkg:` form —
    Hydra's bare `group=name` CLI override only retargets entries WITHOUT an
    explicit package; `group@pkg=name` is needed for the rest."""
    if entry == "_self_":
        return None
    if isinstance(entry, str):
        # bare config name at the same level, merged into root
        return (None, entry, None, False)
    if isinstance(entry, dict):
        (key, name), = entry.items()
        if key == "_self_":
            return None
        if "@" in key:
            group, package = key.split("@", 1)
            return (group, name, package, True)
        return (key, name, key, False)
    raise ValueError(f"Cannot parse defaults entry: {entry!r}")


def compose(
    config_dir: Union[str, Path],
    config_name: str,
    overrides: Sequence[str] = (),
) -> Config:
    """Compose a config like Hydra: defaults tree + CLI overrides.

    `overrides` supports:
      - value overrides  "a.b=3"       (path must exist)
      - value additions  "+a.b=3"      (path may be new)
      - group overrides  "group/sub=name" or "group@pkg=name"
    """
    config_dir = Path(config_dir)

    group_overrides: Dict[str, str] = {}
    value_overrides: List[tuple] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must contain '=': {ov}")
        key, _, val = ov.partition("=")
        # Hydra group-override forms: "group/sub=name", "group@pkg=name",
        # and the bare "group=name" (e.g. `model=sam_pt`) — recognized when
        # the key names a config group directory and isn't a dotted value
        # path.
        grp = key.partition("@")[0]  # package part (after @) may be dotted
        is_group = not key.startswith("+") and "." not in grp and (
            "/" in grp or "@" in key or (config_dir / grp).is_dir()
        )
        if is_group:
            group_overrides[key] = val
        else:
            allow_new = key.startswith("+")
            value_overrides.append((key.lstrip("+"), _parse_scalar(val), allow_new))

    consumed: set = set()
    cfg = _compose_file(config_dir, config_name, package=None,
                        group_prefix="", group_overrides=group_overrides,
                        consumed=consumed)
    unmatched = set(group_overrides) - consumed
    if unmatched:
        raise KeyError(
            f"Group override(s) matched no defaults entry: {sorted(unmatched)}"
        )

    for key, val, allow_new in value_overrides:
        _set_path(cfg, key, val, allow_new=allow_new)
    return cfg


def _compose_file(
    config_dir: Path,
    rel_name: str,
    package: Optional[str],
    group_prefix: str,
    group_overrides: Dict[str, str],
    pkg_prefix: str = "",
    consumed: Optional[set] = None,
) -> Config:
    path = config_dir / f"{rel_name}.yaml"
    raw = load_yaml(path)
    defaults = raw.pop("defaults", [])
    consumed = consumed if consumed is not None else set()

    before_self: Config = {}
    after_self: Config = {}
    target = before_self
    for entry in defaults:
        parsed = _parse_default_entry(entry)
        if parsed is None:
            target = after_self
            continue
        group, name, pkg, explicit_pkg = parsed
        if group is None:
            # bare include, merged into root of this file's config
            sub = _compose_file(config_dir, _sibling(rel_name, name), None,
                                group_prefix, group_overrides,
                                pkg_prefix, consumed)
            target = _merge_into(target, sub)
            continue
        group_key = f"{group_prefix}{group}"
        abs_pkg = f"{pkg_prefix}.{pkg}" if pkg_prefix else pkg
        # Hydra override matching: "group@abs_pkg=name" targets this entry
        # precisely; the bare "group=name" form only retargets entries that
        # did not declare an explicit package.
        qualified = f"{group_key}@{abs_pkg}"
        if qualified in group_overrides:
            name = group_overrides[qualified]
            consumed.add(qualified)
        elif not explicit_pkg and group_key in group_overrides:
            name = group_overrides[group_key]
            consumed.add(group_key)
        sub_rel = _sibling(rel_name, f"{group}/{name}")
        sub_cfg = _compose_file(config_dir, sub_rel, None,
                                f"{group_key}/", group_overrides,
                                abs_pkg, consumed)
        wrapped: Config = {}
        if pkg:
            _set_path(wrapped, pkg, sub_cfg)
        else:
            wrapped = sub_cfg
        target = _merge_into(target, wrapped)

    cfg = _deep_merge(_deep_merge(before_self, raw), after_self)
    return cfg


def _merge_into(acc: Config, new: Config) -> Config:
    merged = _deep_merge(acc, new)
    acc.clear()
    acc.update(merged)
    return acc


def _sibling(rel_name: str, name: str) -> str:
    """Resolve a defaults-list name relative to the including file's dir."""
    if name.startswith("/"):
        return name[1:]
    base = os.path.dirname(rel_name)
    return os.path.join(base, name) if base else name


def _parse_scalar(text: str) -> Any:
    """Parse a CLI override value with YAML scalar semantics."""
    return miniyaml.parse_scalar(text)


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

def resolve_interpolations(cfg: Config, runtime_cwd: Optional[str] = None) -> Config:
    """Resolve ${a.b} references and ${hydra:runtime.cwd} against the root."""
    runtime_cwd = runtime_cwd or os.getcwd()

    def resolve_value(value: Any, seen: frozenset) -> Any:
        if isinstance(value, str):
            return resolve_str(value, seen)
        if isinstance(value, dict):
            return {k: resolve_value(v, seen) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve_value(v, seen) for v in value]
        return value

    def lookup(expr: str, seen: frozenset) -> Any:
        if expr.startswith("hydra:"):
            if expr == "hydra:runtime.cwd":
                return runtime_cwd
            raise KeyError(f"Unsupported hydra resolver: {expr}")
        if expr in seen:
            raise ValueError(f"Circular interpolation: {expr}")
        raw = _get_path(cfg, expr)
        return resolve_value(raw, seen | {expr})

    def resolve_str(s: str, seen: frozenset) -> Any:
        m = _INTERP_RE.fullmatch(s)
        if m:  # whole-string interpolation keeps the referenced type
            return lookup(m.group(1), seen)
        return _INTERP_RE.sub(lambda mm: str(lookup(mm.group(1), seen)), s)

    return resolve_value(cfg, frozenset())


# ---------------------------------------------------------------------------
# Instantiation
# ---------------------------------------------------------------------------

def _locate(target: str) -> Callable:
    module_name, _, attr = target.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def instantiate(cfg: Any, /, _memo: Optional[dict] = None, **kwargs: Any) -> Any:
    """Recursively construct objects from `_target_` nodes (Hydra semantics).

    Nodes may set `_partial_: true` to get a functools.partial instead of a
    call, or `_args_` for positional arguments. Nodes carrying the same
    `_shared_: <key>` marker are instantiated ONCE per top-level call and the
    instance is reused (e.g. one SAM predictor shared between the VIS
    auto-mask generator and the tracker orchestrator — the reference shares
    the SAM model the same way, configs/vis_eval_sam_pt.yaml:9-10).
    """
    import functools

    if _memo is None:
        _memo = {}
    if isinstance(cfg, list):
        return [instantiate(v, _memo=_memo) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v, _memo=_memo) for k, v in cfg.items()}

    cfg = dict(cfg)
    shared_key = cfg.pop("_shared_", None)
    if shared_key is not None:
        # Guard against SILENT config divergence: two nodes sharing a key
        # must carry the same config, otherwise whichever instantiates
        # first would win and the other's settings (variant, checkpoint,
        # ...) would be silently discarded.
        import json

        fingerprint = json.dumps(cfg, sort_keys=True, default=repr)
        seen = _memo.get(("__shared_cfg__", shared_key))
        if seen is not None and seen != fingerprint:
            raise ValueError(
                f"_shared_ key {shared_key!r} is used by two nodes with "
                f"DIFFERENT configs — the second would silently receive "
                f"the first's instance. Align the configs (e.g. point "
                f"both at one interpolated subtree).\n"
                f"first:  {seen}\nsecond: {fingerprint}"
            )
        if shared_key in _memo:
            return _memo[shared_key]
        _memo[("__shared_cfg__", shared_key)] = fingerprint
    target = cfg.pop("_target_")
    partial = cfg.pop("_partial_", False)
    args = [instantiate(a, _memo=_memo) for a in cfg.pop("_args_", [])]
    kw = {
        k: instantiate(v, _memo=_memo)
        for k, v in cfg.items()
        if not k.startswith("_")
    }
    kw.update(kwargs)
    fn = _locate(target)
    if partial:
        obj = functools.partial(fn, *args, **kw)
    else:
        obj = fn(*args, **kw)
    if shared_key is not None:
        _memo[shared_key] = obj
    return obj


# ---------------------------------------------------------------------------
# Entry-point decorator (hydra.main analogue)
# ---------------------------------------------------------------------------

def main(config_dir: str, config_name: str):
    """Decorator: parse sys.argv overrides, compose config, call fn(cfg)."""

    def wrap(fn: Callable[[Config], Any]):
        import functools
        import sys

        @functools.wraps(fn)
        def entry():
            overrides = [a for a in sys.argv[1:] if "=" in a]
            cfg = compose(config_dir, config_name, overrides)
            cfg = resolve_interpolations(cfg)
            return fn(cfg)

        return entry

    return wrap
