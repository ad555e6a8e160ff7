"""The system's runnable workflows (port of the JAX package's ``examples/``).

Each module is a script with ``main(argv=None)``, run as

    python -m dlwp_torch.examples.<name> [flags]

with the flags, defaults and printed lines of the JAX script of the same
name. Every script runs end to end on synthetic demo data
(:mod:`dlwp_torch.examples._synthetic`) when no data file is given. A
script that puts work on a device adds one flag, ``--device``: its default
is ``cuda``, which raises without a card; ``--device cpu`` runs the plain
PyTorch versions of the kernels. The host-only scripts (``write_predictors``,
``add_thickness``, ``write_cfs``, ``write_cfs_reforecast``,
``retrieve_era5``) have no such flag.

| Module | What it does |
| --- | --- |
| ``train_convlstm`` | the ConvLSTM-front-end tower, checkpoints and resume |
| ``validate`` | rollout RMSE against persistence, climatology, barotropic |
| ``run_barotropic`` | batched barotropic integration, 6-hourly snapshots |
| ``train`` | the canonical CNN tower |
| ``train_functional`` | multi-step sequence training |
| ``train_spherical`` | the spherical-CNN stack |
| ``train_distributed`` | (data, lat) mesh training |
| ``make_barotropic_archive`` | a barotropic-dynamics predictor file |
| ``write_predictors`` | data source -> scaled series predictor file |
| ``add_thickness`` | a derived thickness channel in a predictor file |
| ``write_cfs``, ``write_cfs_reforecast``, ``retrieve_era5`` | acquisition |
| ``plot_forecasts``, ``plot_movie``, ``plot_ensemble`` | figures |
"""
