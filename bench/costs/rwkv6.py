"""Model FLOPs of an RWKV6 (Finch) stack as the port computes it (five
token-shifted projections and the output projection in the time mix,
two in the channel mix, RMSNorm between), from the published widths of a
configuration file.

N is every matrix parameter of the stack, and the output head apart; the
embedding is a gather and counts nothing. A token costs 2 FLOPs a
parameter served and 6 trained. WKV adds its state products, 4·head_size²
a step and head in the forward (:mod:`bench.costs.wkv`), counted as
attention's products are: three times the forward when trained. Remat's
recomputation is not counted."""


def layer_matrix_params(c: dict) -> int:
    d, ff = c["hidden_size"], c["intermediate_size"]
    return 6 * d * d + 2 * d * ff


def head_params(c: dict) -> int:
    return c["hidden_size"] * c["vocab_size"]


def wkv_flops(c: dict, tokens: int) -> int:
    """Forward state products of every layer over ``tokens`` steps."""
    hs = c["head_size"]
    heads = c["hidden_size"] // hs
    return c["num_hidden_layers"] * 4 * hs * hs * heads * tokens


def train_flops(c: dict, b: int, s: int) -> int:
    """One optimizer step over ``b`` sequences of ``s`` tokens."""
    n = c["num_hidden_layers"] * layer_matrix_params(c) + head_params(c)
    return 6 * n * b * s + 3 * wkv_flops(c, b * s)
