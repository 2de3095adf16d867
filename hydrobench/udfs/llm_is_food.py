"""LLM_is_food(tokens): the serving CLI's predicate, the program's own
``launch.serve.build_llm_udf`` (a dense decoder's forward, then the
token-pool score) on the benchmark's weights and configuration."""

NAME = "LLM_is_food"


def build(cfg, params, device):
    from repro_torch.launch.serve import build_llm_udf

    return build_llm_udf(params=params, cfg=cfg, device=device)
