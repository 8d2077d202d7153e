"""Architecture configs ported so far + registry."""

from importlib import import_module

ARCH_IDS = ("smollm_360m", "olmoe_1b_7b", "recurrentgemma_2b", "mamba2_2p7b")
ALIASES = {"smollm-360m": "smollm_360m", "olmoe-1b-7b": "olmoe_1b_7b",
           "recurrentgemma-2b": "recurrentgemma_2b", "mamba2-2.7b": "mamba2_2p7b"}


def get_config(name: str, smoke: bool = False, fused: bool = True,
               max_batch: int = None, max_seq: int = None):
    """Resolve an arch config, as the reference's ``get_config`` does.

    The port runs only the reference's ``fused=True`` numerics: posit
    division (posit16 by default; ``cfg.with_numerics(div_format=...)`` takes
    any planned format, posit64 included) through the SRT kernels and
    attention through the posit flash kernel, so ``fused`` defaults to True
    and False raises.
    ``max_batch``/``max_seq`` override the serving defaults.
    """
    if not fused:
        raise NotImplementedError(
            "the port runs only the fused posit numerics; float division and "
            "the chunked attention are not ported (ROADMAP.md)")
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"arch {name!r} is not ported; have {sorted(set(ALIASES) | set(ARCH_IDS))}")
    mod = import_module(f"repro_torch.configs.{mod_name}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    serve_kw = {}
    if max_batch is not None:
        serve_kw["serve_max_batch"] = int(max_batch)
    if max_seq is not None:
        serve_kw["serve_max_seq"] = int(max_seq)
    return cfg.replace(**serve_kw) if serve_kw else cfg
