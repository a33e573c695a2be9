"""Model family: blocks and the SeqVaeTeb sequence VAE."""

from .blocks import (LSTM, CausalConv1d, CausalConvBlock, LSTMStream,
                     ReflectConvBlock, ResidualMLP, geometric_schedule,
                     linear_upsample, run_lstm_streams)
from .vae_teb import (ConditionalEncoder, Decoder, SeqVaeTeb, SourceEncoder,
                      TargetEncoder, compute_loss, decoder_loss, gaussian_kld,
                      gaussian_nll, source_stream_init_state,
                      stitch_predictions)

__all__ = [
    "LSTM", "CausalConv1d", "CausalConvBlock", "LSTMStream",
    "ReflectConvBlock", "ResidualMLP", "geometric_schedule",
    "linear_upsample", "run_lstm_streams",
    "ConditionalEncoder", "Decoder", "SeqVaeTeb", "SourceEncoder",
    "TargetEncoder", "compute_loss", "decoder_loss", "gaussian_kld",
    "gaussian_nll", "source_stream_init_state", "stitch_predictions",
]
