"""How a cell's traffic drives the system, one module per entry
(``entries/<entry>.py``, named by the workload file's ``entry``). Each gives:

* ``setup(run)``: build the system from the configuration, warm up every
  shape the window uses; returns the entry's state;
* ``call(state, i)``: the window's call ``i``; returns (work done, info) or
  None when there is nothing left to do;
* ``answers(state)``: after the window, every answer to judge: a dict of
  ``qidx`` [A], ``ids`` [A, k] (corpus rows), ``dists`` [A, k], ``rows``
  (corpus rows the answers are over), ``attempted`` and ``failed``;
* ``shapes(state)``: the shapes the per-layer readers count work from;
* ``release(state)``: free the system's device state.
"""
