"""The most device memory the port held at once over set-up and window
(``torch.cuda.max_memory_allocated``), the fullest card's, in GiB."""


def read(record: dict) -> float:
    return record["peak_bytes"] / 2 ** 30
