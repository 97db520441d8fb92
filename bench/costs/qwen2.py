"""Model FLOPs of a Qwen2 decoder (GQA with QKV bias, SwiGLU MLP), from
the published widths of a configuration file (``configs/<name>.json``).

N is every matrix parameter of the stack, and the output head apart (the
embedding's transpose where the configuration ties them: a product all the
same); the embedding's gather counts nothing. A matrix product of a token
costs 2 FLOPs a parameter served and 6 trained; attention adds its
products over the visible causal (query, key) pairs, 4·head_dim a pair
and query head, forward only when served and three times that (forward
and backward) when trained. Remat's recomputation is not counted."""


def head_dim(c: dict) -> int:
    return c["hidden_size"] // c["num_attention_heads"]


def layer_matrix_params(c: dict) -> int:
    d, ff = c["hidden_size"], c["intermediate_size"]
    q = c["num_attention_heads"] * head_dim(c)
    kv = c["num_key_value_heads"] * head_dim(c)
    return d * q + 2 * d * kv + q * d + 3 * d * ff


def head_params(c: dict) -> int:
    return c["hidden_size"] * c["vocab_size"]


def attention_flops(c: dict, pairs: int) -> int:
    """Forward products of every layer over ``pairs`` (query, key)
    pairs."""
    return (c["num_hidden_layers"] * 4 * head_dim(c)
            * c["num_attention_heads"] * pairs)


def prefill_flops(c: dict, s: int) -> int:
    """A prefill of ``s`` tokens from position 0: every layer over every
    token, the head over the last one (the only logits it needs)."""
    return (2 * c["num_hidden_layers"] * layer_matrix_params(c) * s
            + 2 * head_params(c) + attention_flops(c, s * (s + 1) // 2))


def decode_flops(c: dict, pos: int) -> int:
    """One token decoded at position ``pos`` (``pos`` tokens before it):
    every layer and the head, attention over ``pos + 1`` keys."""
    return (2 * (c["num_hidden_layers"] * layer_matrix_params(c)
                 + head_params(c)) + attention_flops(c, pos + 1))


def train_flops(c: dict, b: int, s: int) -> int:
    """One optimizer step over ``b`` sequences of ``s`` tokens."""
    n = c["num_hidden_layers"] * layer_matrix_params(c) + head_params(c)
    return 6 * n * b * s + 3 * b * attention_flops(c, s * (s + 1) // 2)
