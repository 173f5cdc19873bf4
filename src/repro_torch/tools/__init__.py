"""The port's sweep command lines, each `main(argv) -> int` over
`repro_torch.api` and `repro_torch.obs`, run as
`python -m repro_torch.tools.<name>`: `run_shard` (one shard of a
manifest; exit 0, or 3 when points were quarantined), `merge_stores`
(`--verify` exits 4 on a corrupt source unless `--repair`), `sweep_top`
(the fleet dashboard over shard heartbeats) and `trace_export` (the
schedule and serving traces and the bottleneck report, byte-identical
across runs).  They keep the flags, outputs and exit codes of the JAX
package's `tools/*.py`."""
