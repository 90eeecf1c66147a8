# Subpackages import directly (e.g. repro.dataflow.physical); keeping this
# empty avoids a circular import with repro.core.plan.
