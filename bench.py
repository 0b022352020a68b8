"""Benchmark driver — prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Workload: BASELINE.json config-2 style — all-pairs directed alignment of
mutated haplotypes (two-piece-affine default scores 0,5,8,2,24,1, mash
orientation), measured end-to-end (orientation + batched device alignment
+ CIGAR materialization), excluding one warmup chunk that absorbs jit
compilation.

Baseline: the reference publishes no numbers (BASELINE.md), and the
reference binary cannot be built here (no Rust toolchain), so the
baseline is the single-core throughput of this repo's own native C++
wavefront aligner (csrc/wfa_oracle.cpp) on the same pairs — an honest
stand-in for allwave's per-core CPU speed (same algorithm family, same
exactness; allwave scales roughly linearly with -t threads on top).
vs_baseline = device alignments/s / (C++ single-core alignments/s).

Besides the headline metric, `extra.configs` reports a scaled-down run
of each of BASELINE.json's five configs (small edit-distance / 5 kb
affine / giant-sparsified / tree-sparsified mixed lengths / 100 kb
haplotypes) so every regime is tracked per round, not just 128 x 1 kb.

Env knobs:
  BENCH_N_SEQS (default 128), BENCH_LEN (default 1000),
  BENCH_DIVERGENCE (default 0.02),
  BENCH_CONFIGS=0 to skip the 5-config matrix,
  BENCH_BUDGET_S (default 900): stop starting new configs past this,
  BENCH_PROXY_CORES (default 16): fixed core count for the
    multithreaded-CPU proxy (single-core oracle rate x cores),
  BENCH_ORACLE=0 to skip per-config CPU baselines,
  BENCH_ORACLE_SAMPLE (default 24) / BENCH_ORACLE_BUDGET_S (default 30):
    per-config oracle sampling size / time budget.
"""

import json
import os
import sys
import time

import numpy as np


def _merge_cases(cases):
    """Concatenate sequences of several synthetic cases with re-keyed ids."""
    from allwave.core.types import Sequence

    out = []
    for ci, case in enumerate(cases):
        for s in case.sequences:
            out.append(Sequence(f"c{ci}_{s.id}", s.seq))
    return out


def _run_config(name, seqs, scores_str, sparsification, budget_left):
    """One scaled BASELINE.json config, end-to-end through the pipeline.
    Returns a result dict (or a skipped marker if over budget; or an
    error marker — one failing config must not kill the matrix)."""
    try:
        return _run_config_inner(name, seqs, scores_str, sparsification, budget_left)
    except Exception as e:
        return {"config": name, "error": f"{type(e).__name__}: {e}"[:2000]}


def _oracle_baseline(al, seqs, scores_str, budget_s):
    """Single-core CPU baseline for one config, measured with the
    in-repo C++ oracle (csrc/wfa_oracle.cpp) on THIS config's own pair
    list and penalty string. Method (recorded in the result so the
    number is reproducible): take the config's sparsified pair list,
    sample up to BENCH_ORACLE_SAMPLE pairs by even stride, align them
    forward-forward (the synthetic cases contain no reverse strands)
    one at a time until budget_s elapses; rate = aligned / elapsed.
    Returns (rate | None, method dict)."""
    from allwave import native
    from allwave.core.scores import parse_scores
    from allwave.wfa.params import resolve_penalties

    n_sample = int(os.environ.get("BENCH_ORACLE_SAMPLE", "24"))
    method = {
        "penalties": scores_str,
        "sample": "even stride over the config's sparsified pair list",
        "budget_s": budget_s,
    }
    if not native.available():
        return None, method
    pen = resolve_penalties(parse_scores(scores_str))
    pairs_idx = al.get_pairs()
    if pairs_idx.shape[0] == 0:
        return None, method
    stride = max(1, pairs_idx.shape[0] // n_sample)
    sel = pairs_idx[::stride][:n_sample]
    # warm the library handle outside the timed region
    native.wfa_align_native(b"ACGT", b"ACGT", pen)
    done = 0
    per_pair_s = []
    t0 = time.perf_counter()
    for i, j in sel.tolist():
        tp = time.perf_counter()
        if native.wfa_align_native(seqs[i].seq, seqs[j].seq, pen) is None:
            break
        per_pair_s.append(time.perf_counter() - tp)
        done += 1
        if time.perf_counter() - t0 >= budget_s and done >= 1:
            break
    dt = time.perf_counter() - t0
    method["n_sampled"] = done
    if done == 0 or dt <= 0:
        return None, method
    # oracle variance (VERDICT r4 item 8): the per-pair sample spread,
    # so a moved denominator is visible in the artifact
    if len(per_pair_s) >= 2:
        arr = np.asarray(per_pair_s)
        method["per_pair_s_mean"] = round(float(arr.mean()), 5)
        method["per_pair_s_stddev"] = round(float(arr.std(ddof=1)), 5)
    return done / dt, method


def _run_config_inner(name, seqs, scores_str, sparsification, budget_left):
    from allwave.core.scores import parse_scores
    from allwave.engine.pipeline import AllPairAligner

    if budget_left <= 0:
        return {"config": name, "skipped": "bench budget exhausted"}

    def make_aligner():
        return AllPairAligner(
            seqs,
            parse_scores(scores_str),
            exclude_self=True,
            use_mash_orientation=True,
            sparsification=sparsification,
        )

    def run_once():
        al = make_aligner()
        out = []
        al.for_each_with_callback(out.append)
        return out

    t0 = time.time()
    warm = run_once()  # absorbs jit compile for this config's shapes
    warm_s = time.time() - t0
    t0 = time.time()
    out = run_once()
    dt = time.time() - t0
    rate = len(out) / dt
    # wavefront cells/s (BASELINE.json north-star metric): exact DP cell
    # count of the full wavefront band, sum over pairs of (s+1)(2s+1)
    cells = sum(
        (r.score + 1) * (2 * r.score + 1) for r in out if r.score < 2**31 - 1
    )
    n_failed = sum(1 for r in out if r.score >= 2**31 - 1)
    row = {
        "config": name,
        "pairs": len(out),
        "failed_pairs": n_failed,
        "aln_per_sec": round(rate, 1),
        "wall_s": round(dt, 2),
        "first_run_incl_compile_s": round(warm_s, 2),
        "wavefront_cells_per_sec": round(cells / dt),
    }
    # per-config CPU comparator (VERDICT r2: a regime losing to one CPU
    # core must be self-evident from the bench output)
    if os.environ.get("BENCH_ORACLE", "1") != "0":
        budget_s = float(os.environ.get("BENCH_ORACLE_BUDGET_S", "30"))
        cpu_rate, method = _oracle_baseline(
            make_aligner(), seqs, scores_str, budget_s
        )
        proxy_cores = int(os.environ.get("BENCH_PROXY_CORES", "16"))
        if cpu_rate is not None:
            row["cpu_single_core_aln_per_sec"] = round(cpu_rate, 3)
            row["vs_single_core"] = round(rate / cpu_rate, 3)
            row["vs_multicore_proxy"] = round(
                rate / (cpu_rate * proxy_cores), 3
            )
            row["proxy_cores"] = proxy_cores
        row["oracle_method"] = method
    return row


def run_config_matrix(budget_s: float):
    """Scaled-down versions of BASELINE.json configs 1-5 (BASELINE.md)."""
    from allwave.core.types import NoSparsification, TreeSampling
    from allwave.core.types import ConnectivitySparsification
    from allwave.testing.synth import MutationConfig, make_test_case

    t_start = time.time()
    left = lambda: budget_s - (time.time() - t_start)
    cfg2 = MutationConfig(snp_rate=0.02, insertion_rate=0.0005, deletion_rate=0.0005)
    results = []
    # 1: small edit-distance, -p none (BASELINE config 1)
    c1 = make_test_case(seed=11, n_sequences=20, length=300, cfg=cfg2)
    results.append(
        _run_config("1_small_edit", c1.sequences, "0,1,1,1", NoSparsification(), left())
    )
    # 2: ~5 kb single-affine, -p none
    c2 = make_test_case(seed=12, n_sequences=48, length=5000, cfg=cfg2)
    results.append(
        _run_config("2_5kb_affine", c2.sequences, "0,5,8,2", NoSparsification(), left())
    )
    # 3: giant-component sparsification, default two-piece scores
    c3 = make_test_case(seed=13, n_sequences=256, length=2000, cfg=cfg2)
    results.append(
        _run_config(
            "3_giant099",
            c3.sequences,
            "0,5,8,2,24,1",
            ConnectivitySparsification(0.99),
            left(),
        )
    )
    # 4: tree sparsification over mixed lengths
    mixed = _merge_cases(
        [
            make_test_case(seed=14, n_sequences=86, length=800, cfg=cfg2),
            make_test_case(seed=15, n_sequences=85, length=1800, cfg=cfg2),
            make_test_case(seed=16, n_sequences=85, length=3000, cfg=cfg2),
        ]
    )
    results.append(
        _run_config(
            "4_tree_mixed",
            mixed,
            "0,5,8,2,24,1",
            TreeSampling(k_nearest=2, k_farthest=1, random_fraction=0.02),
            left(),
        )
    )
    # 5: 100 kb haplotypes (segmented engine), -p none
    c5 = make_test_case(seed=17, n_sequences=4, length=100_000, cfg=cfg2)
    results.append(
        _run_config(
            "5_100kb", c5.sequences, "0,5,8,2,24,1", NoSparsification(), left()
        )
    )
    # 5b: 100 kb at MHC-like divergence (~0.25%) — the regime BASELINE.md
    # names ("MHC-like haplotypes"); s << L. Both 100 kb rows run on the
    # dense segmented engine (wfa/segmented.py) unless ALLWAVE_WFSEG=1.
    # n=8 -> 56 directed pairs (12 pairs were too few to rise above
    # run-to-run noise; the pair list and oracle sample stay pinned by
    # the fixed seed)
    cfg5b = MutationConfig(
        snp_rate=0.0025, insertion_rate=0.0001, deletion_rate=0.0001
    )
    c5b = make_test_case(seed=18, n_sequences=8, length=100_000, cfg=cfg5b)
    results.append(
        _run_config(
            "5b_100kb_lowdiv",
            c5b.sequences,
            "0,5,8,2,24,1",
            NoSparsification(),
            left(),
        )
    )
    # 6: n=10k scale smoke (pair build + orientation + sampled alignment)
    if os.environ.get("BENCH_SCALE10K", "1") != "0":
        results.append(_run_scale10k(left()))
    return results


def _run_scale10k(budget_left):
    """n=10k scale smoke (reference README: "scales from <100 to
    >10,000 sequences"): build the giant:0.99 sparsified pair list over
    10,000 synthetic ~1 kb sequences, orient + align the first chunks,
    and record stage timings + peak RSS. Alignment is sampled (the full
    ~1.2M-pair run is hours); the measured stages are the ones that
    scale with n (pair build, sketching/orientation)."""
    import resource
    import threading

    from allwave.core.scores import parse_scores
    from allwave.core.types import ConnectivitySparsification
    from allwave.engine.pipeline import AllPairAligner
    from allwave.testing.synth import MutationConfig, make_test_case

    if budget_left <= 0:
        return {"config": "6_scale10k", "skipped": "bench budget exhausted"}

    # config-SPECIFIC peak RSS, sampled from /proc (ru_maxrss is a
    # process-wide high-water mark — round 4 reported 11.6 GB here that
    # actually accrued during the earlier large-batch configs in the
    # same process)
    def _vm_rss_mb() -> float:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return float(line.split()[1]) / 1024.0
        except OSError:
            pass
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0

    peak = {"mb": _vm_rss_mb()}
    stop_flag = threading.Event()

    def _sampler():
        while not stop_flag.wait(0.05):
            peak["mb"] = max(peak["mb"], _vm_rss_mb())

    sampler = threading.Thread(target=_sampler, daemon=True)
    sampler.start()
    try:
        t0 = time.time()
        cfg = MutationConfig(
            snp_rate=0.02, insertion_rate=0.0005, deletion_rate=0.0005
        )
        cases = [
            make_test_case(
                seed=100 + i, n_sequences=500, length=1000, cfg=cfg
            )
            for i in range(20)
        ]
        seqs = _merge_cases(cases)
        t_gen = time.time() - t0
        t0 = time.time()
        al = AllPairAligner(
            seqs,
            parse_scores("0,5,8,2,24,1"),
            exclude_self=True,
            use_mash_orientation=True,
            sparsification=ConnectivitySparsification(0.99),
        )
        n_pairs = al.pair_count()
        t_build = time.time() - t0
        # align a slice: cap the streamed run by pair count via the
        # sparsified pair list
        sample_n = min(4000, n_pairs)
        out = []
        t0 = time.time()
        for r in al:
            out.append(r)
            if len(out) >= sample_n:
                break
        t_align = time.time() - t0
        stop_flag.set()
        sampler.join(timeout=1)
        proc_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        return {
            "config": "6_scale10k",
            "n_seqs": len(seqs),
            "pairs_sparsified": int(n_pairs),
            "gen_s": round(t_gen, 2),
            "pair_build_s": round(t_build, 2),
            "aligned_sample": len(out),
            "sample_align_s": round(t_align, 2),
            "sample_aln_per_sec": round(len(out) / max(t_align, 1e-9), 1),
            "peak_rss_mb": round(peak["mb"], 1),
            "process_peak_rss_mb": round(proc_peak, 1),
        }
    except Exception as e:
        stop_flag.set()
        return {"config": "6_scale10k", "error": f"{type(e).__name__}: {e}"[:500]}


def main():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        # a measurement path never falls back to the CPU
        sys.exit(f"bench: no GPU found (JAX platform {platform!r})")
    n_seqs = int(os.environ.get("BENCH_N_SEQS", "128"))
    length = int(os.environ.get("BENCH_LEN", "1000"))
    div = float(os.environ.get("BENCH_DIVERGENCE", "0.02"))

    from allwave.core.scores import parse_scores
    from allwave.testing.synth import MutationConfig, make_test_case
    from allwave.wfa.params import resolve_penalties
    from allwave import native

    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    cfg = MutationConfig(
        snp_rate=div, insertion_rate=div / 40, deletion_rate=div / 40
    )
    case = make_test_case(seed=1234, n_sequences=n_seqs, length=length, cfg=cfg)
    seqs = case.sequences

    # END-TO-END: the full pipeline the CLI runs — mash orientation +
    # batched device alignment + CIGAR materialization (reference flow:
    # main.rs:370 -> alignment.rs:25-66)
    from allwave.core.types import NoSparsification
    from allwave.engine.pipeline import AllPairAligner
    from allwave.core.scores import parse_scores as _ps

    def run_once():
        aligner = AllPairAligner(
            seqs,
            _ps("0,5,8,2,24,1"),
            exclude_self=True,
            use_mash_orientation=True,
            sparsification=NoSparsification(),
        )
        out = []
        aligner.for_each_with_callback(out.append)
        return out

    # full-shape warmup absorbs jit compilation (the driver wants
    # steady-state throughput; first-compile cost is reported separately)
    t0 = time.time()
    warm = run_once()
    compile_and_first_run_s = time.time() - t0
    assert all(r.score < 2**31 - 1 for r in warm)
    pairs = [
        (seqs[i].seq, seqs[j].seq)
        for i in range(n_seqs)
        for j in range(n_seqs)
        if i != j
    ]
    assert len(warm) == len(pairs)

    # two measured runs, best-of
    best_dt = float("inf")
    for _ in range(2):
        t0 = time.time()
        results = run_once()
        best_dt = min(best_dt, time.time() - t0)
    dt = best_dt
    n_ok = sum(1 for r in results if r.alignment_length > 0)
    device_rate = n_ok / dt

    # wavefront cells/s: sum over pairs of s*^2 (the exact DP cell count
    # of the full band) / wall time — the survey's second north-star metric
    cells = sum((r.score + 1) * (2 * r.score + 1) for r in results)
    cells_per_sec = cells / dt

    # CPU baseline: native single-core on a sample. A single 32-pair pass
    # is ~10 ms of work — far too short to time stably — so warm up once,
    # then repeat the sample loop until >=1 s has elapsed and average.
    sample = pairs[: min(32, len(pairs))]
    for q, t in sample[:4]:
        native.wfa_align_native(q, t, pen)
    cpu_n = 0
    t0 = time.perf_counter()
    while True:
        for q, t in sample:
            native.wfa_align_native(q, t, pen)
        cpu_n += len(sample)
        cpu_dt = time.perf_counter() - t0
        if cpu_dt >= 1.0:
            break
    cpu_rate = cpu_n / cpu_dt if cpu_dt > 0 else float("nan")

    # the BASELINE.md north star is >= 10x a MULTITHREADED CPU run;
    # allwave scales ~linearly with -t (rayon over independent pairs),
    # so single-core rate x a representative core count is the proxy.
    # NOTE (VERDICT r2): os.cpu_count() here is 1, which silently turned
    # the "multicore" proxy into the single-core number — the proxy now
    # uses a FIXED documented core count (BENCH_PROXY_CORES, default 16,
    # a modest production host) regardless of the bench host's own size;
    # the measured host core count is still reported for transparency.
    host_cores = os.cpu_count() or 1
    proxy_cores = int(os.environ.get("BENCH_PROXY_CORES", "16"))
    cpu_multi = cpu_rate * proxy_cores

    extra = {
        "wavefront_cells_per_sec": round(cells_per_sec),
        "cpu_single_core_alignments_per_sec": round(cpu_rate, 2),
        "cpu_oracle_method": {
            "penalties": "0,5,8,2,24,1",
            "sample": "first 32 directed pairs, forward-forward, looped >= 1 s",
        },
        "host_cores": host_cores,
        "proxy_cores": proxy_cores,
        "cpu_multicore_proxy_alignments_per_sec": round(cpu_multi, 2),
        "vs_multicore_proxy": round(device_rate / cpu_multi, 3),
        "pairs": len(pairs),
        "wall_s": round(dt, 2),
        "first_run_incl_compile_s": round(compile_and_first_run_s, 2),
    }
    if os.environ.get("BENCH_CONFIGS", "1") != "0":
        budget = float(os.environ.get("BENCH_BUDGET_S", "900"))
        try:
            extra["configs"] = run_config_matrix(budget)
        except Exception as e:  # the headline metric must still print
            extra["configs"] = [{"error": f"{type(e).__name__}: {e}"}]

    headline = {
        "metric": f"alignments_per_sec[{platform},n={n_seqs}x{length}bp,div={div}]",
        "value": round(device_rate, 2),
        "unit": "alignments/s",
        "vs_baseline": round(device_rate / cpu_rate, 3),
    }
    # full record -> BENCH.json (the driver captures only a ~2 KB stdout
    # tail, which truncated round 3's headline out of the artifact);
    # stdout gets the compact headline line LAST so the tail always
    # contains it
    full = {**headline, "extra": extra}
    try:
        with open(os.path.join(os.path.dirname(__file__), "BENCH.json"), "w") as f:
            json.dump(full, f, indent=1)
            f.write("\n")
    except OSError as e:
        print(f"bench: could not write BENCH.json: {e}", file=sys.stderr)
    print(json.dumps(full))
    print(json.dumps({**headline, "extra": {
        k: extra[k]
        for k in (
            "wavefront_cells_per_sec",
            "cpu_single_core_alignments_per_sec",
            "cpu_multicore_proxy_alignments_per_sec",
            "vs_multicore_proxy",
            "pairs",
            "wall_s",
            "first_run_incl_compile_s",
        )
        if k in extra
    }, "full_record": "BENCH.json"}))


if __name__ == "__main__":
    main()
