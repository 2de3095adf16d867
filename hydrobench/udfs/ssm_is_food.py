"""SSM_is_food(tokens): a Hydro UDF written as a user writes one, over the
program's Mamba2 forward (``repro_torch.models.ssm.forward``) on the
worker thread's own stream, with the token-pool score of the serving
CLI's ``build_llm_udf`` copied here and frozen: a row's float32
log-softmax summed over its live positions (id > 0), averaged over the
food words less the average over the service words."""

import numpy as np

NAME = "SSM_is_food"
FOOD_WORDS = list(range(10, 60))
SERVICE_WORDS = list(range(60, 110))


def build(cfg, params, device):
    import torch

    from repro_torch.core.udf import UDF
    from repro_torch.kernels import launch
    from repro_torch.models import ssm
    from repro_torch.udfs.library import token_ids

    dev = launch.require_device(device)
    food = torch.as_tensor(FOOD_WORDS, device=dev)
    service = torch.as_tensor(SERVICE_WORDS, device=dev)

    def score(tokens):  # (rows, L) int32, 0-padded
        logits = ssm.forward(cfg, params, {"tokens": tokens})
        mask = (tokens > 0)[..., None].to(logits.dtype)
        pooled = (torch.log_softmax(logits.to(torch.float32), -1)
                  * mask).sum(1)
        return pooled[:, food].mean(-1) - pooled[:, service].mean(-1)

    def fn(data):
        tokens = np.asarray(data["tokens"])
        with torch.inference_mode(), launch.thread_stream(dev):
            out = score(token_ids(tokens, tokens.shape[1], cfg.vocab_size,
                                  dev))
            return out.cpu().numpy()

    return UDF("SSM", fn, columns=("tokens",), resource="cuda:0",
               proxy_cost=lambda d: float((d["tokens"] > 0).sum()))
