"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
the port's reduced config of the same family (2 layers, d 256), prompts
divided by 64 and long outputs by 16, four slots."""
import copy

import lib

TINY = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
            num_key_value_heads=4, num_hidden_layers=2, vocab_size=512,
            head_dim=64, smoke=True)


def tiny_cell(name: str, dtype: str = "bfloat16", rate: float = 4.0,
              serve=None) -> dict:
    cell = copy.deepcopy(lib.assemble(MERGE_WORKLOAD) if name == MERGE
                         else lib.cell(name))
    c = cell["config"]
    c.update(TINY, dtype=dtype)
    if c["patches"]:
        c["patches"] = 8
    t = cell["traffic"]
    for cl in t["classes"]:
        # prompts / 64; outputs / 16 where longer than 32 tokens
        div = {"prompt": 64, "output": 16 if cl["output"]["max"] > 32 else 1}
        for k in ("prompt", "output"):
            for q in ("median", "min", "max"):
                if q in cl[k]:
                    cl[k][q] = max(2, cl[k][q] // div[k])
    if "rate_req_s" in t:
        t["rate_req_s"] = rate
    if "clients" in t:
        t["clients"] = 4
    s = cell["serve"]
    s["serve"].update(max_batch=4, max_seq=256)
    if serve:
        s["serve"].update(serve)
    for w in s["warmup"]:
        w["prompt"] = max(2, w["prompt"] // 64)
        w["output"] = min(w["output"], 4)
    s["profile_s"] = 1
    s["drain_s"] = 30
    return cell


RAG = "qwen2.5-32b-l16.rag"
DOC = "phi-3-vision-4.2b.docqa-batch"
MERGE = "qwen2.5-32b-l16.merge"
#: the merge cell's entry: its files are kept, but ``BENCHMARK.json`` does
#: not list it while its TPOT tail spreads past any bound (PERF.md)
MERGE_WORKLOAD = {"name": MERGE, "config": "qwen2.5-32b-l16",
                  "traffic": "merge", "chips": 1}
#: a tiny merge: one instance holds 128 tokens, long prompts 140-234
MERGE_SERVE = {"max_seq": 128}
