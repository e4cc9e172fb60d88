"""`utilities.neurokit_connector`: the reference's `NeuroPawnConnector`.

Keeps the reference surface (neurokit_connector.py:10-67): start_stream /
get_window ([C, T]) / stop_stream over a board resolved from
`serial_port` (a board spec or a Board object), through the port's
runtime/connector.Connector.
"""

from neural_speech_decoding_tpu_torch.runtime.connector import Connector


class NeuroPawnConnector(Connector):
    def __init__(self, serial_port, num_channels: int = 8, buffer_size: int = 450000):
        super().__init__(serial_port, num_channels=num_channels, buffer_size=buffer_size)
        self.params = None  # BrainFlowInputParams equivalent not needed
