"""The command-line entry points, each run as ``python -m
esmstereo_tpu_torch.cli.<name>`` or through its ``main(argv)``:
``make_filelists``, ``train_sceneflow``, ``train_kitti``, ``test_kitti``,
``save_disp``, ``test_mid`` and ``test_eth3d``, the counterparts of the
JAX package's ``tools/`` scripts with their flags and defaults. They run
on the card unless ``--cpu`` is given."""
