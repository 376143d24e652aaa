"""The benchmark of open_diffusiongs_tpu_torch on NVIDIA H100 cards.

`python3 -m odgs_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json; odgs_bench/harness.py says
where each part of a cell lives.  Nothing here imports JAX or the JAX
package.
"""
