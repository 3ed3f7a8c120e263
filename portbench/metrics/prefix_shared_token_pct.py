"""The engine's prefix cache: tokens it served from shared pages
(``stats()['prefix_tokens_shared']``, counted at admission) over the
prompt tokens of the requests admitted in the window."""


def read(record):
    w = record.get("work")
    if not w or not w["admitted_prompt_tokens"]:
        return None
    return 100.0 * w["shared_tokens"] / w["admitted_prompt_tokens"]
