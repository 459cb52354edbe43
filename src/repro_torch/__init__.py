"""PyTorch/CUDA port of the exact top-K system (``repro`` is the reference).

The port serves the paper's exact top-K query over a separable linear
model on one NVIDIA GPU: ``SepLRModel`` -> ``build_index`` and the
``norm_major`` layout -> the engine registry (``naive``, ``norm`` and the
hand-written CUDA kernel engine ``topk_mips``) -> ``TopKServer.query``.
It also serves the recsys models (``models.recsys``: the query tower as
the SEP-LR query, exact retrieval, then ``TwoStageRanker``'s full-model
re-rank) and the dense LMs (``models.transformer``: ``prefill``, then
``serve_step`` through the exact top-K vocab head), and trains the
recsys models, the LMs and the PNA GNN (``models.gnn``) through
``launch.train``.

Every entry point takes ``device=None``, which means ``"cuda"``: the port
runs on the card unless the caller asks for the CPU, and it raises rather
than quietly running on the CPU when no card is present.
"""

from __future__ import annotations

import torch

# Scores are fp32 end to end, as in the reference (``preferred_element_type
# =float32``), and the parity tests hold them to 1e-4..1e-5. TF32 keeps
# about three decimal digits, so it stays off for every matmul the port
# issues (the lb0 pre-screen, the ``norm`` scan, ``naive``).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when a CUDA device is asked for and
    none is present (never fall back to the CPU behind the caller's back).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
