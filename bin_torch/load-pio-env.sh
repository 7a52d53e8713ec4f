#!/usr/bin/env bash
# Source conf/pio-env.sh (or $PIO_CONF_DIR/pio-env.sh) into the calling
# shell. Role of the reference's bin/load-pio-env.sh: one place where the
# PIO_STORAGE_* / server env vars come from.
if [ -z "$PIO_HOME" ]; then
  export PIO_HOME="$(cd "$(dirname "${BASH_SOURCE[0]}")/.."; pwd)"
fi
PIO_CONF_DIR="${PIO_CONF_DIR:-$PIO_HOME/conf}"
if [ -f "$PIO_CONF_DIR/pio-env.sh" ]; then
  . "$PIO_CONF_DIR/pio-env.sh"
fi
