"""The training run's peak of allocated device memory
(``torch.cuda.max_memory_allocated``): the batch a card can hold."""

LAYER = "Device"
SOURCE = "program_counter"
UNIT = "GiB"
MOVES = "train_frames_per_s"


def read(layer):
    if not layer.get("peak_mem_bytes"):
        return None
    return layer["peak_mem_bytes"] / 2**30
