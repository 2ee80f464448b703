"""whisper-tiny — encoder-decoder audio backbone, conv frontend stubbed [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a stub: callers provide
precomputed frame embeddings of shape (batch, encoder_seq_len, d_model)
(``repro_torch.models.frontend``).  The values are the JAX package's.
"""
from repro_torch.configs.base import (ArchConfig, EncDecConfig,
                                      VerticalConfig, register)

WHISPER_TINY = register(
    ArchConfig(
        name="whisper-tiny",
        family="audio",
        num_layers=4,  # decoder layers
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        rope_theta=10000.0,
        encdec=EncDecConfig(encoder_layers=4, encoder_seq_len=1500),
        # modality-natural vertical split: mel-band groups across clients
        vertical=VerticalConfig(num_clients=2, tower_layers=1, merge="avg"),
        source="arXiv:2212.04356",
    )
)
