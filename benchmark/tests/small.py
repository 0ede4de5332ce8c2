"""The configurations cut to a size a CPU test run holds."""

# each configuration cut to a size a test run holds; the widths of the
# problem class (n = 100 k, m = 100 n) are kept
SMALL = {
    "portfolio": {"k": 2, "n": 200, "dims": {"l": 200},
                  "shapes": {"n_var": 202, "m": 200, "p": 3,
                             "kkt_order": 405}},
    "lasso": {"n": 3, "m": 300, "dims": {"l": 6},
              "shapes": {"n_var": 306, "m": 6, "p": 300,
                         "kkt_order": 612}},
}
