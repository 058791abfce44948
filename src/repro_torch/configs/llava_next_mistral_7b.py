"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b]
— VLM: the assigned scope is the language decoder; the SigLIP/CLIP
vision tower is a STUB. input_specs supplies precomputed anyres patch
embeddings (up to 5 tiles × 576 patches = 2880 prefix positions) which
pass through a trainable linear projector.
"""

from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    period=(LayerSpec(),),
    rope_theta=1_000_000.0,
    frontend="vision",
)
