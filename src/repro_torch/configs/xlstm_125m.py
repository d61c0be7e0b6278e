"""xlstm-125m — sLSTM + mLSTM blocks.

[ssm] 12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304
[arXiv:2405.04517; unverified]

Every 4th layer is sLSTM (scalar memory, sequential recurrence); the rest
are mLSTM (matrix memory, chunked-parallel). d_ff=0: the xLSTM block has
its own up/down projections instead of a separate MLP. Recurrent state is
O(1) in sequence -> runs long_500k.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=4,
    ssm_state=64,
    tie_embeddings=True,
    subquadratic=True,
    fsdp=False,
    pure_dp=True,    # 125M with 4 heads: TP=16 would shard nothing useful;
                     # the model axis carries batch instead (§Perf hillclimb)
    microbatches=4,
    source="arXiv:2405.04517; unverified",
))
