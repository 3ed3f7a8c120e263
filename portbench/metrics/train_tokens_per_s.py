"""Every token of the steps completed in the window, over the window."""


def read(record):
    if record["kind"] != "train" or not record["steps"]:
        return None
    return record["tokens"] / record["window_s"]
