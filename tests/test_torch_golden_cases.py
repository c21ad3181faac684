"""The PyTorch port against recorded JAX outputs, one test item per topic.

Every case of tests/torch_cases.py rebuilds its inputs from a seed with
numpy, runs the port's function on CPU tensors and compares the digest of
its output exactly with the JAX package's, recorded in
tests/golden/torch_cases.json by tools/make_torch_goldens.py. The cases
cover the first slice (kernels K1-K4, K2 also through its fused entry on
hard operands, bit deposit, the parse, the
predefined-table encode, SLICE_CONFIG frames at 8-16 KB blocks), the
second (custom FSE tables per stream, the state chains, the Huffman stages,
DEFAULT_CONFIG frames and level 1/3/5 item frames at 16 KB blocks, with and
without checksum) and the third (decode checkpoints, decode_accel frames
and their sidecar, the host format copies, the plain versions of the decode
kernels K6-K9, and `prepare_decompress_batch` on the port's accel and plain
frames and on libzstd's, and on a batch of multi-block frames of the port
and of libzstd with its window-cap refusal) and the fourth (min_match 3, the near-offset band,
the wide sort key, the search over the whole block, LDM, the plain version
of the segment DP K10 (also on its hard set `opt_hard`), the optimal parse
with its overflow poison, and
level 7/12/19/22 item frames at 16 KB blocks) and the fifth (the plain
versions of the row sort K12, the fused match finder K13 (both also on
their hard sets) and the bit deposit K11, and `find_matches` with
`use_pallas_match`, both as the JAX
package runs it on the CPU and through the fused route) and the public
surface (the host codec's frames and its decoder on the JAX package's, the
port's and libzstd's frames and on corrupt ones, `decompress_batch_tpu` on a
batch with repeat offsets carried across blocks, an 8 MiB window without a
content size, skippable frames and a checksum, the streaming decoder fed in
1-, 7- and 4096-byte chunks, `Manager` on both routes, the top-level
functions, `BatchManager.decompress_batch` with a corrupt item, the size
estimates and validators, streaming XXH64 and XXH32) and the last modules
(the native host runtime: XXH64/32, the frame assembler, the Huffman stream
decoder against the reference's Python chain, the native engine's frames
and their decode; `HybridEngine`'s routing matrix, its ADAPTIVE switch, its
frames and decode routes; adaptive levels; the nvCOMP container; the OOM
split-and-retry of `BatchManager`); stock libzstd (`zstandard`) decodes
every port frame.

This file imports neither JAX nor the JAX package and compiles nothing but
the port's native host library, which g++ builds in the background while
the first topics run. It holds nine items: pytest-xdist's `--dist loadfile`
queues files by item count, largest first, so with nine items it queues
beside the nine-item reference files, after every reference file with more
items, and the reference files keep the order and the workers they have
without it. The live comparisons against the JAX package
(tests/test_torch_{kernels,parse,fse,pipeline,fse_custom,huffman,
manager,accel,decode,optimal,api,windows}.py) also hold the recorded
digests against the JAX package's live output.
"""

import ast
import pathlib
import threading

import pytest
import torch
import torch_cases
import zstandard

# Topic -> the cases it checks; every case stands in exactly one topic.
TOPICS = {
    "kernels": ["roll_u8", "roll_i32", "roll_hard", "concat", "concat_fused", "greedy",
                "greedy_hard", "rep", "rep_hard",
                "decode_sequences_serial", "decode_sequences_chunked", "decode_sequences_hard",
                "decode_huffman",
                "decode_huffman_hard",
                "execute_sequences", "execute_sequences_hard",
                "opt_steps_mm3_cap64", "opt_steps_mm4_cap16", "opt_hard", "sort_rows_1024",
                "sort_rows_2048",
                "sort_rows_8192", "sort_rows_hard", "match_windows_d2_w2", "match_windows_d8_w8",
                "match_windows_hard",
                "deposit_pallas_0", "deposit_pallas_1", "deposit_pallas_2",
                "deposit_pallas_sparse", "deposit_pallas_edge"],
    "deposit_parse_predefined": ["deposit_scatter", "deposit_tree", "parse_8k",
                                 "encode_predefined", "find_matches_wide", "find_matches_whole",
                                 "find_matches_fused_two_band",
                                 "find_matches_long", "parse_optimal", "parse_optimal_overflow",
                                 "find_matches_fused", "find_matches_win_start",
                                 "find_matches_long_win_start", "parse_dict",
                                 "parse_payload_only", "parse_sample_log", "parse_dec_min_ml"],
    "slice1_frames": ["frame_slice1_8k", "frame_slice1_16k"],
    "fse_tables": ["normalize_64", "ncount_fields", "build_cf_tables", "choose_tables_ll",
                   "choose_tables_of", "choose_tables_ml", "format_decode"],
    "chains_encode": ["chain_sequences", "chain_weights", "chain_hard", "prepare_sequences_auto",
                      "encode_prepared", "encode_prepared_ckpt"],
    "huffman_stages": ["huffman_histogram", "huffman_lengths", "huffman_codes",
                       "huffman_weights_header", "huffman_weights_fse", "huffman_4stream",
                       "huffman_literals", "huffman_literals_ckpt", "lit_compressed_header"],
    "default_frames": ["frame_default_8k", "frame_default_16k", "frame_default_16k_checksum",
                       "accel_records", "accel_items_16k", "accel_items_16k_checksum",
                       "decompress_batch_accel", "decompress_batch_plain",
                       "decompress_batch_zstd", "decompress_multiblock", "host_decode",
                       "decompress_batch_tpu", "streaming_decode", "hybrid_routes",
                       "adaptive_levels", "nvcomp_container", "batch_degraded"],
    "level_frames": ["frame_level1_checksum", "frame_level5", "items_level3_checksum", "xxh64",
                     "items_level7", "items_level12", "items_level19", "items_level22",
                     "frame_whole_block", "host_compress", "manager_surface", "items_ldm",
                     "items_history_level3", "items_history_level19", "streaming_compress",
                     "train_dictionary", "dict_frames", "items_rung_edge", "native_runtime",
                     "native_engine"],
}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _native_build():
    """Start the build of the native host library (a g++ subprocess) while
    the first topics run; a case that needs it waits on the loader's lock,
    and a failed build raises again in that case."""
    from tpu_zstd_torch.utils import native

    build = threading.Thread(target=native.get_native, daemon=True)
    build.start()
    yield
    build.join()


@pytest.fixture(scope="module")
def golden():
    return torch_cases.load_golden()


def _check_case(name, golden):
    """The port's digest for case `name` equals the recorded one, and stock
    libzstd decodes every frame it returns to its input (with the case's
    raw-content dictionary, `zstd_dict` for every frame or `zstd_dicts`
    one a frame, where it has one)."""
    c = torch_cases.CASES[name]
    inputs = c.inputs()
    out = c.port(inputs)
    assert torch_cases.digest(out) == golden[name], "differs from the recorded JAX output"
    datas = inputs.get("items") or ([inputs["data"]] if "data" in inputs else [])
    # frame0, frame1, ..., frame10: the frames in item order.
    frames = [v for _, v in sorted(out.items(), key=lambda kv: (len(kv[0]), kv[0]))
              if isinstance(v, bytes)]
    assert len(frames) == len(datas)
    dicts = inputs.get("zstd_dicts") or [inputs.get("zstd_dict")] * len(frames)
    for frame, data, dct in zip(frames, datas, dicts):
        dctx = zstandard.ZstdDecompressor(dict_data=zstandard.ZstdCompressionDict(
            dct, dict_type=zstandard.DICT_TYPE_RAWCONTENT) if dct else None)
        assert dctx.decompress(frame, max_output_size=max(len(data), 1)) == data


@pytest.mark.parametrize("topic", list(TOPICS))
def test_port_equals_recorded_jax_output(topic, golden):
    failed = {}
    for name in TOPICS[topic]:
        try:
            _check_case(name, golden)
        except AssertionError as e:
            failed[name] = str(e) or "assertion failed"
    assert not failed, failed


def test_every_case_is_recorded_and_this_file_imports_no_jax(golden):
    assert set(golden) == set(torch_cases.CASES)
    in_topics = [n for names in TOPICS.values() for n in names]
    assert sorted(in_topics) == sorted(torch_cases.CASES)
    here = pathlib.Path(__file__).resolve().parent
    for f in (here / "test_torch_golden_cases.py", here / "torch_cases.py"):
        tree = ast.parse(f.read_text())
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        mods = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "tpu_zstd")], f.name
