"""`utilities.streaming_process`: the reference's `StreamingProcess`.

The thread-based producer with the reference's surface (reference:
streaming_process.py:10-77): recording_flag.value, stop(), payload dicts
on the out queue, over the port's runtime/streaming.StreamingProducer.
`serial_port` takes a board spec or a Board object.
"""

from neural_speech_decoding_tpu_torch.runtime.streaming import (  # noqa: F401
    StreamingProducer,
)


class StreamingProcess(StreamingProducer):
    def __init__(
        self,
        serial_port,
        num_channels: int = 8,
        window_seconds: float = 5.0,
        out_queue=None,
        start_recording: bool = False,
        buffer_size: int = 450000,
        **kwargs,
    ):
        super().__init__(
            serial_port,
            num_channels=num_channels,
            window_seconds=window_seconds,
            out_queue=out_queue,
            start_recording=start_recording,
            buffer_size=buffer_size,
        )
