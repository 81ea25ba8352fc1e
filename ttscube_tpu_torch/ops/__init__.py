from ttscube_tpu_torch.ops.rnn import LSTM, GRU, LSTMCell, GRUCell
from ttscube_tpu_torch.ops.conv import Conv1d, ConvTranspose1d, WNConv1d, WNConvTranspose1d
from ttscube_tpu_torch.ops.length_regulator import regulate_length, durations_to_frame2phone

__all__ = [
    "LSTM", "GRU", "LSTMCell", "GRUCell",
    "Conv1d", "ConvTranspose1d", "WNConv1d", "WNConvTranspose1d",
    "regulate_length", "durations_to_frame2phone",
]
