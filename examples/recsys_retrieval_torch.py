"""Two-stage recsys serving on the PyTorch/CUDA port: train DeepFM on
synthetic clicks, then serve retrieval through the EXACT SEP-LR top-K
engine and re-rank the retrieved candidates with the full
(non-separable) model.

    PYTHONPATH=src python examples/recsys_retrieval_torch.py               # card
    PYTHONPATH=src python examples/recsys_retrieval_torch.py --device cpu

On the card the model's forward runs kernels B5 (``embedding_bag``) and
B6 (``fm_interaction``), and training differentiates through them; the
``bta`` retrieval scores its list tail with kernel B4 (``gather_scores``).
On the CPU each takes its plain PyTorch version.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import from_matrix_factorization
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import recsys_batches
from repro_torch.models import recsys as recsys_mod
from repro_torch.serving.server import TopKServer, TwoStageRanker
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

CFG = recsys_mod.RecsysConfig("deepfm-demo", "deepfm", n_dense=0,
                              n_sparse=12, embed_dim=16,
                              vocab_per_field=2000, mlp_dims=(64, 64))
N_CANDIDATES = 20_000
STEPS = 150


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    dev = torch.device(ap.parse_args(argv).device)

    # 1) train the ranking model on synthetic click logs
    params = recsys_mod.init_params(CFG, torch.Generator(dev).manual_seed(0),
                                    dev)
    opt = OptimizerConfig(kind="adamw", lr=3e-3, warmup_steps=10,
                          total_steps=STEPS)
    data = PrefetchLoader(lambda: recsys_batches(
        0, CFG.n_dense, CFG.n_sparse, CFG.vocab_per_field, 256))
    tr = Trainer(lambda p, b: recsys_mod.loss_fn(p, b, CFG), params, opt,
                 data, TrainerConfig(total_steps=STEPS, log_every=25))
    final = tr.run()
    data.close()
    print(f"DeepFM trained on {dev}: loss {tr.history[0]['loss']:.4f} -> "
          f"{final['loss']:.4f} (acc {final['acc']:.2%})")

    # 2) candidate catalogue = item-tower embeddings (SEP-LR by design)
    rng = np.random.default_rng(1)
    candidates = (rng.standard_normal((N_CANDIDATES, CFG.embed_dim))
                  .astype(np.float32)
                  * (1.0 / np.sqrt(1.0 + rng.random(N_CANDIDATES)))[:, None]
                  ).astype(np.float32)
    retrieval = TopKServer(from_matrix_factorization(candidates, "items",
                                                     device=dev),
                           max_batch=16, block_size=256, device=dev)

    # 3) two-stage: exact top-100 retrieval -> full-model re-rank
    def rerank(query_batch, cand_ids):
        # full DeepFM forward on (query, candidate) pairs: inject the
        # candidate id into the last sparse field
        B, N = cand_ids.shape
        sp = np.repeat(np.asarray(query_batch["sparse"]), N, axis=0)
        sp[:, -1] = cand_ids.reshape(-1) % CFG.vocab_per_field
        with torch.no_grad():
            logits = recsys_mod.forward(
                tr.params, {"dense": np.zeros((B * N, 0), np.float32),
                            "sparse": sp}, CFG)
        return logits.reshape(B, N).cpu().numpy()

    ranker = TwoStageRanker(retrieval, rerank, retrieve_n=100)
    queries = next(iter(PrefetchLoader(lambda: recsys_batches(
        7, CFG.n_dense, CFG.n_sparse, CFG.vocab_per_field, 4))))
    with torch.no_grad():
        U = recsys_mod.query_tower(tr.params, queries, CFG)
    ids, scores = ranker.rank(queries, U, k=5, method="bta")
    st = retrieval.stats["bta"]
    print(f"retrieved top-100 of {N_CANDIDATES} exactly with "
          f"{st.scores_per_query:.0f} scores/query "
          f"({st.scores_per_query / N_CANDIDATES:.1%} of naive), "
          f"then re-ranked to top-5:")
    for b in range(4):
        print(f"  query {b}: items {ids[b].tolist()}")
    bta = retrieval.query(U, 100, method="bta")
    naive = retrieval.query(U, 100, method="naive")
    same = (np.allclose(bta.values, naive.values, rtol=1e-5, atol=1e-5)
            and all(set(bta.indices[b]) == set(naive.indices[b])
                    for b in range(4)))
    print(f"bta's top-100 equals naive's: {same}")


if __name__ == "__main__":
    main()
