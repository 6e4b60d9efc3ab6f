"""The port's measurement and corpus tools, one module for each script of
the JAX package's `scripts/` with the same file name: `flops_analysis`,
`streaming_roofline`, `bench_train_step`, `serve_device_floor`,
`serve_load`, `bench_dwconv` and `make_synth_corpus`. Each runs as
`python -m hilcodec_tpu_torch.scripts.<name> ...`; importing one runs
nothing."""


def pop_device(argv):
    """(argv without `--device D`, D or None): the device flag of the
    tools whose other arguments are positional."""
    argv = list(argv)
    if "--device" not in argv:
        return argv, None
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:], argv[i + 1]
