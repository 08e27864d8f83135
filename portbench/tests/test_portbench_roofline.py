"""The frozen counts against values worked by hand at one shape."""
from roofline import counts as RC

QWEN = {"hidden_size": 5120, "num_attention_heads": 40,
        "num_key_value_heads": 8, "intermediate_size": 27648,
        "num_hidden_layers": 16, "vocab_size": 152064}


def test_flash_counts():
    # S=4, Hq 2, kv 1, dh 8, bf16: pairs 10; q,k,v,out = 4*(16+8+8+16)*2 B
    c = RC.flash(1, 4, 2, 1, 8)
    assert c == {"bytes": 384, "flops": 4 * 10 * 2 * 8}


def test_chunk_counts():
    # S=2 after 3 prefix keys, Hq 2, kv 1, dh 8, 64 position slots:
    # pairs 2*3 + 3 = 9; prefix K+V 3*1*2*8*2 = 96; q,k,v,out
    # 2*8*(4+2)*2 = 192; q positions 8; kv positions 256; scatter 64
    c = RC.chunk(2, 3, 2, 1, 8, True, 64)
    assert c == {"bytes": 96 + 192 + 8 + 256 + 64, "flops": 4 * 9 * 2 * 8}
    first = RC.chunk(2, 3, 2, 1, 8, False, 64)
    assert first == {"bytes": 192 + 8 + 64, "flops": 4 * 3 * 2 * 8}


def test_decode_counts():
    # B=2 rows, 100 visible pairs, Hq 4, kv 2, dh 8, 3 pages, 192 slots:
    # K+V 100*2*2*8*2 = 6400; q+out 2*2*4*8*2 = 256; positions 2*192*4;
    # q positions 8; page table 2*3*4
    c = RC.decode(2, 100, 4, 2, 8, 3, 192)
    assert c == {"bytes": 6400 + 256 + 1536 + 8 + 24,
                 "flops": 4 * 100 * 4 * 8}


def test_bound_takes_the_larger():
    assert RC.bound_s(3.35e12, 0.0) == 1.0
    assert RC.bound_s(0.0, 989e12) == 1.0


def test_model_flops():
    lin = 5120 * 128 * (80 + 16) + 3 * 5120 * 27648
    assert RC.linear_params(QWEN) == lin == 487_587_840
    # the token at position 0: 16 layers, one key, and the head
    assert RC.token_flops(QWEN, 0, True) == \
        16 * (2 * lin + 4 * 40 * 128) + 2 * 5120 * 152064
    # a prompt of 3: positions 0, 1, 2 see 1, 2, 3 keys; head once
    assert RC.prefill_flops(QWEN, 0, 3) == \
        3 * 16 * 2 * lin + 4 * 40 * 128 * 16 * 6 + 2 * 5120 * 152064
    # the decode of the 4th token adds exactly one position
    assert RC.prefill_flops(QWEN, 0, 4) - RC.prefill_flops(QWEN, 0, 3) == \
        RC.token_flops(QWEN, 3, False)
